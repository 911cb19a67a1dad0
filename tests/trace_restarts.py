"""Stops and starts ``torch.profiler`` profiles inside the port's trace spans:
on the span's own thread (by hand and by a profiler schedule stepping inside
a span), and from another thread while ``serve`` answers requests. Prints
``ok`` and exits 0 when every profile read back. A range ended under a later
profile than the one that opened it writes into the stopped profile's freed
records, which glibc's malloc checks report as heap corruption: ``checked``
runs this script under them (``tests/test_torch_port_trace.py``, and with
``--device cuda`` ``tests/test_torch_port_cuda.py``).

    PYTHONPATH=. python tests/trace_restarts.py --device cpu|cuda --artifact DIR [--rounds N]

The other thread's profiles record the host alone, in torch's default mode,
which records the ranges of the thread that started the profile only: the
hazard is the host's; torch's ``profile_all_threads`` mode corrupts the heap
beside a served request with the port's tracing left out; and under the
malloc checks, profiles with CUDA activity started and stopped beside the
replays did not end within 450 s on an H100 (12.5 s without the checks).
The kernels are built before the checks (an ``nvcc`` under them is slow).
"""

import argparse
import ctypes.util
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from rdmnet_tpu_torch import serving, trace
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.models import RDMNet

ROUNDS = 20  # restarts on the span's own thread, by hand and by the schedule
REQUESTS = 6  # served while another thread restarts its profile


def activities(device):
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def same_thread(device, rounds):
    x = torch.ones(64, device=device)
    for _ in range(rounds):
        first, second = profile(activities=activities(device)), profile(
            activities=activities(device))
        first.__enter__()
        with trace.span("outer"):  # opened under the first, ended under the second
            x = x * 2
            first.__exit__(None, None, None)
            second.__enter__()
            with trace.span("inner"):
                x = x + 1
        second.__exit__(None, None, None)
        first.key_averages()
        second.key_averages()
    with profile(activities=activities(device), acc_events=True,
                 schedule=schedule(wait=0, warmup=0, active=1, repeat=0)) as prof:
        for _ in range(rounds):
            with trace.span("step"):  # each step's profile stops and the next starts inside
                x = x - 1
                prof.step()
    prof.key_averages()


def other_thread(device, artifact):
    serve, meta = serving.load_exported(artifact, device=device)
    ref, _, _ = procedural_pair(3, n_rings=16, n_azimuths=200)
    ref = ref[np.random.RandomState(0).permutation(len(ref))[:480], :3].astype(np.float32)
    src = (ref + np.array([0.3, 0.2, 0.0], np.float32)).astype(np.float32)
    serve(ref, src)
    failed = []

    def requests():
        try:
            for _ in range(REQUESTS):
                serve(ref, src)
        except Exception as e:  # the main thread reports it
            failed.append(e)

    worker = threading.Thread(target=requests)
    worker.start()
    while worker.is_alive():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            time.sleep(0.01)
        prof.key_averages()
    worker.join()
    if failed:
        raise failed[0]


def checked(device: str, artifact: str, rounds: int = ROUNDS,
            timeout: float = 600) -> subprocess.CompletedProcess:
    """This script in a process of its own under glibc's malloc checks
    (``libc_malloc_debug`` preloaded where the C library has one)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MALLOC_CHECK_="3", MALLOC_PERTURB_="165",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    debug = ctypes.util.find_library("c_malloc_debug")
    if debug:
        env["LD_PRELOAD"] = debug
    return subprocess.run([sys.executable, os.path.abspath(__file__), "--device", device,
                           "--artifact", artifact, "--rounds", str(rounds)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--artifact", required=True,
                        help="a directory for the tiny model's served artifact")
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    args = parser.parse_args()
    device = torch.device(args.device)
    cfg = make_tiny_cfg()
    serving.export_inference(cfg, RDMNet(cfg, device="cpu"), args.artifact,
                             bucket_scales=(1.0,))
    t0 = time.perf_counter()
    same_thread(device, args.rounds)
    print(f"same thread: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    other_thread(device, args.artifact)
    print(f"and the other thread: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    names = {s.name for s in trace.snapshot()["spans"]}
    assert {"outer", "inner", "step", "serve", "serve.launch"} <= names, names
    print("ok")


if __name__ == "__main__":
    main()
