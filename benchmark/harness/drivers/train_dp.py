"""Data-parallel training: ``world`` ranks, one process and one card each,
as ``rdmnet-torch-trainval --dp <world>`` runs them. Each rank drives the
port's ``capture_train_step`` under the process group (a ``SplitProgram``:
the gradient half, the all-reduce, the update half) fed by its own shard of
one shuffled order (``PairLoader(num_hosts=world, host_id=rank)``) over the
dataset root the parent writes at set-up (the ``train`` driver's). NCCL on
cards, gloo on the CPU (the tests).

The ranks start together, run the checked steps and the warm-up, then the
window: rank 0 reads the clock after every step and a broadcast over a gloo
group of its own stops every rank after the same step. The rate is all the
ranks' pairs over the window they share; the loader wait and the idle share
are the worst rank's. The reference follows the first steps with the ranks'
pairs as one batch, each pair drawing from its rank's target generator.

Traffic parameters: the ``train`` driver's, and ``world``."""

from __future__ import annotations

import dataclasses
import gc
import queue
import socket
import sys
import tempfile
import time
import traceback
from typing import Dict, Optional

import numpy as np

from benchmark.harness import guard, seeds
from benchmark.harness.drivers import train
from benchmark.harness.record import note
from benchmark.harness.trace import span, trace_calls
from benchmark.harness.weights import draw_weights, load_weights

# a function "module:attr" each rank calls first (the tests plant faults with it)
RANK_HOOK: Optional[str] = None
SETUP_S = 240.0  # a rank's set-up, checked steps, warm-up and trace, beyond the window


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, job: dict, out) -> None:
    """One rank: its program, its checked steps, the window; its record to ``out``."""
    try:
        out.put((rank, _rank(rank, world, port, job)))
    except BaseException as e:  # noqa: BLE001 - the parent raises it with the rank's traceback
        out.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))


def _rank(rank: int, world: int, port: int, job: dict) -> dict:
    import importlib

    import torch
    import torch.distributed as dist

    if job["hook"]:
        mod, attr = job["hook"].split(":")
        getattr(importlib.import_module(mod), attr)()
    torch.set_num_threads(2)
    cuda = job["device"] == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            **({"device_id": device} if cuda else {}))
    ctrl = dist.new_group(backend="gloo")
    try:
        if rank == 0:  # the parent stays off the cards: rank 0 casts the scans on its own
            train.write_root(job["root"], job["cell"], job["seed"], device)
        dist.barrier(group=ctrl)
        return _run_rank(rank, world, job, device, ctrl)
    finally:
        dist.destroy_process_group()


def _run_rank(rank, world, job, device, ctrl) -> dict:
    import torch
    import torch.distributed as dist

    from rdmnet_tpu_torch import engine
    from rdmnet_tpu_torch.models import RDMNet

    cell, seed, t = job["cell"], job["seed"], job["cell"].traffic
    cfg = train.port_config(cell)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, dp=world))
    loader = train.make_loader(cell, cfg, job["root"], seed, rank, world)
    model = RDMNet(cfg, device=device)
    load_weights(model, draw_weights({n: tuple(p.shape) for n, p in model.named_parameters()},
                                     seeds.stream(seed, "weights"), device))
    state = engine.create_train_state(cfg, model, steps_per_epoch=len(loader), dp_size=world)
    generator = torch.Generator(device).manual_seed(train.target_seed(seed, rank))
    group = dist.group.WORLD
    if device.type == "cuda":
        program = engine.capture_train_step(state, cfg, t["batch_size"], generator, device,
                                            group)
    else:
        from rdmnet_tpu_torch.engine.train_step import batch_inputs, build_batch

        step = engine.make_train_step(cfg, device, group)

        def program(np_batch):
            inputs = {k: torch.as_tensor(v) for k, v in batch_inputs(np_batch).items()}
            return step(state, build_batch(inputs, cfg.pyramid), generator)[1]

    start = train.snapshot(state)
    batches = train.endless(loader)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    rec: Dict[str, object] = {"steps_per_epoch": len(loader)}
    # the eager warm-ups and the capture, then the checked steps from the seed's state
    rec["fed"] = [{k: np.array(b[k]) for k in train.BATCH_KEYS}
                  for b in (next(batches) for _ in range(t["check_steps"]))]
    for batch in rec["fed"]:
        program(batch)

    losses, grads, after = train.checked_steps(program, state, rec["fed"], start, generator,
                                               train.target_seed(seed, rank))
    del start
    if rank == 0:  # numpy: a queue passes torch tensors by handles that die with the rank
        rec["grads"] = {n: g.numpy() for n, g in grads.items()}
        rec["after"] = [{n: a.numpy() for n, a in st.items()} for st in after]
        rec["losses"] = losses
    rec["digest"] = float(sum(float(a.double().sum()) for a in after[-1].values()))
    for _ in range(t["warmup_steps"]):
        program(next(batches))
    sync()
    count0 = state.count
    flag = torch.zeros(1)
    dist.barrier(group=ctrl)
    rec["setup_end"] = time.perf_counter()

    steps, waits = 0, []
    t0 = time.perf_counter()
    while True:
        tw = time.perf_counter()
        batch = next(batches)
        waits.append(time.perf_counter() - tw)
        program(batch)
        steps += 1
        if rank == 0:
            flag.fill_(float(time.perf_counter() - t0 >= job["seconds"]))
        dist.broadcast(flag, src=0, group=ctrl)
        if flag.item():
            break
    sync()
    t1 = time.perf_counter()
    rec.update(t0=t0, t1=t1, steps=steps, waits=waits, skipped=steps - (state.count - count0))
    if job["trace"]:
        def call(i):
            with span("loader.next"):
                b = next(batches)
            with span("program"):
                program(b)

        rec["timeline"] = trace_calls(call, t["trace_steps"], sync)
    rec["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                if device.type == "cuda" else 0)
    rec["forbidden"] = guard.loaded_forbidden()  # what the port loaded in this rank
    batches.close()
    dist.barrier(group=ctrl)
    return rec


def run(cell, rec, device, t_start: float) -> Dict[str, object]:
    import multiprocessing as mp

    import torch

    t = cell.traffic
    world = t["world"]
    tmp = tempfile.TemporaryDirectory(prefix="bench-root-")
    job = {"cell": cell, "seed": rec.seed, "seconds": rec.seconds, "trace": rec.trace,
           "root": tmp.name, "device": device.type, "hook": RANK_HOOK}
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, job, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, dict] = {}
    try:
        deadline = time.time() + SETUP_S + rec.seconds
        while len(results) < world:
            try:
                rank, res = out.get(timeout=max(1.0, deadline - time.time()))
            except queue.Empty:
                raise RuntimeError(f"train_dp: {world - len(results)} ranks gave no result")
            if "error" in res:
                raise RuntimeError(f"train_dp: rank {rank} failed:\n{res['error']}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=20)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        tmp.cleanup()
    ranks = [results[r] for r in range(world)]
    rec.setup_s = max(r["setup_end"] for r in ranks) - t_start
    t0, t1 = min(r["t0"] for r in ranks), max(r["t1"] for r in ranks)
    rec.window_s = t1 - t0
    steps = ranks[0]["steps"]
    rec.attempted = steps * world
    rec.failed = ranks[0]["skipped"] * world
    rec.items = steps * world * t["batch_size"]
    rec.device_count = world
    worst = max(ranks, key=lambda r: np.mean(r["waits"]))
    rec.loader_wait_s = worst["waits"]
    rec.e2e["dp_train_pairs_per_s"] = rec.items / rec.window_s
    rec.e2e["setup_s"] = rec.setup_s
    rec.memory_peak_bytes = max(r["memory_peak_bytes"] for r in ranks)
    rec.timelines = [r["timeline"] for r in ranks if "timeline" in r]
    rec.forbidden = sorted({f"{n} (rank {i})" for i, r in enumerate(ranks)
                            for n in r["forbidden"]})
    fed = [{k: np.concatenate([r["fed"][i][k] for r in ranks]) for k in train.BATCH_KEYS}
           for i in range(len(ranks[0]["fed"]))]
    digests = [r["digest"] for r in ranks]
    print(f"ranks' parameter sums after the checked steps: {digests}", file=sys.stderr)
    tensors = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    return {"fed": fed, "losses": ranks[0]["losses"], "grads": tensors(ranks[0]["grads"]),
            "after": [tensors(st) for st in ranks[0]["after"]],
            "steps_per_epoch": ranks[0]["steps_per_epoch"],
            "digests": digests, "world": world}


def check(cell, rec, device, state, tf32: bool = False) -> None:
    t_check = time.perf_counter()
    ref, start, flops = train.reference_steps(cell, rec.seed, device, state["fed"],
                                              state["steps_per_epoch"], tf32,
                                              count_flops=rec.trace, world=state["world"],
                                              states=state["after"][:-1])
    rec.checks = train.train_checks(state, ref, start)
    rec.checks["ranks_differ"] = float(len(set(state["digests"])) - 1)
    rec.flops_per_item = flops  # a pair's, rated over one card's pairs a second
    note("reference steps", t_check)
    gc.collect()


def control(cell, seed: int, device) -> Dict[str, float]:
    """TF32 reference in the program's place, on the ranks' first batches."""
    t = cell.traffic
    world = t["world"]
    cfg = train.port_config(cell)
    with tempfile.TemporaryDirectory(prefix="bench-root-") as root:
        train.write_root(root, cell, seed, device)
        per_rank = []
        for rank in range(world):
            loader = train.make_loader(cell, cfg, root, seed, rank, world, prefetch=0)
            batches = train.endless(loader)
            per_rank.append([{k: np.array(b[k]) for k in train.BATCH_KEYS}
                             for b in (next(batches) for _ in range(t["check_steps"]))])
            steps_per_epoch = len(loader)
    fed = [{k: np.concatenate([r[i][k] for r in per_rank]) for k in train.BATCH_KEYS}
           for i in range(t["check_steps"])]
    tf32, start, _ = train.reference_steps(cell, seed, device, fed, steps_per_epoch, True,
                                           world=world)
    checks = train.control_checks(cell, seed, device, fed, steps_per_epoch, tf32, start, world)
    checks["ranks_differ"] = 0.0  # one process holds every rank's pairs
    return checks
