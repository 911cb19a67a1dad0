"""Served registration: one client in a closed loop calling the port's
``serve`` (``serving.export_inference`` -> ``load_exported``) on
consecutive-frame pairs of seeded procedural sequences, cycled in a seeded
order.

Traffic parameters: ``bucket_scales`` (the artifact's buckets),
``sequences`` x ``frames`` (the pool of pairs), ``n_rings``,
``n_azimuths``, ``step`` (m a frame), ``enrich`` (terrain and clutter),
``warmup_requests``, ``trace_requests`` (the traced sub-window),
``check_requests`` (the sample of the window's answers the reference judges)."""

from __future__ import annotations

import gc
import sys
import tempfile
import time
from typing import Dict

import numpy as np

from benchmark.harness import judge, scans, seeds
from benchmark.harness.record import note
from benchmark.harness.trace import span, trace_calls
from benchmark.harness.weights import draw_weights, load_weights

def port_config(cell):
    from rdmnet_tpu_torch.config import Config, config_from_dict

    return config_from_dict(Config, cell.config["config"])


def pair_pool(cell, seed: int, device):
    t = cell.traffic
    return scans.pair_pool(seeds.stream(seed, "traffic"), t["sequences"], t["frames"],
                           t["n_rings"], t["n_azimuths"], t["step"], t["enrich"], device)


def request_order(n_pairs: int, seed: int, length: int) -> np.ndarray:
    """Pair index of each request: seeded permutations of the pool, one after another."""
    rng = seeds.rng(seed, "order")
    reps = -(-length // n_pairs)
    return np.concatenate([rng.permutation(n_pairs) for _ in range(reps)])[:length]


def run(cell, rec, device, t_start: float) -> Dict[str, object]:
    """Set-up, the window, the traced sub-window (``rec.trace``); fills ``rec``.
    Returns what ``check`` needs."""
    import torch

    from rdmnet_tpu_torch import serving
    from rdmnet_tpu_torch.models import RDMNet

    t = cell.traffic
    cfg = port_config(cell)
    model = RDMNet(cfg, device=device)
    weights = draw_weights({n: tuple(p.shape) for n, p in model.named_parameters()},
                           seeds.stream(rec.seed, "weights"), device)
    load_weights(model, weights)
    del weights
    note("model built, weights drawn", t_start)
    pairs = pair_pool(cell, rec.seed, device)
    note(f"{len(pairs)} pairs cast", t_start)
    with tempfile.TemporaryDirectory(prefix="bench-artifact-") as art:
        serving.export_inference(cfg, model, art, bucket_scales=t["bucket_scales"])
        del model
        gc.collect()
        note("artifact written", t_start)
        serve, _ = serving.load_exported(art, device=device)
    note("artifact loaded and captured", t_start)
    order = request_order(len(pairs), rec.seed, 1 << 16)
    for i in range(t["warmup_requests"]):
        ref, src, _ = pairs[order[i]]
        serve(ref, src)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec.setup_s = time.perf_counter() - t_start

    kept = Reservoir(t["check_requests"], seeds.rng(rec.seed, "sample"))
    lat, failed = [], 0
    k = t["warmup_requests"]
    t0 = time.perf_counter()
    while True:
        ref, src, _ = pairs[order[k]]
        ts = time.perf_counter()
        try:
            out = serve(ref, src)
        except Exception as e:  # noqa: BLE001 - a request that fails is counted, the run goes on
            print(f"register: request {k} failed: {e!r}", file=sys.stderr)
            out = None
            failed += 1
        te = time.perf_counter()
        lat.append(te - ts)
        kept.offer((int(order[k]), out))
        k += 1
        if te - t0 >= rec.seconds:
            break
    rec.window_s = te - t0
    rec.attempted = len(lat)
    rec.failed = failed
    rec.items = rec.attempted - rec.failed
    rec.e2e["pairs_per_s"] = rec.items / rec.window_s
    rec.e2e["pair_ms_p95"] = float(np.percentile(np.asarray(lat) * 1e3, 95))
    rec.e2e["setup_s"] = rec.setup_s

    traced = []
    if rec.trace:
        start = k

        def call(i):
            ref, src, _ = pairs[order[start + i]]
            traced.append(int(order[start + i]))
            with span("serve"):
                serve(ref, src)

        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
        rec.timelines = [trace_calls(call, t["trace_requests"], sync)]
    if device.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    del serve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"pairs": pairs, "kept": kept.items, "traced": traced}


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``
    (Algorithm R): the window keeps only the answers the reference judges."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def reference_answers(cell, seed: int, device, pairs, indices, tf32: bool,
                      count_flops: bool = False):
    """The reference's served outputs of pool pairs ``indices`` (each once)
    and, with ``count_flops``, the FLOPs of the first one's pass."""
    import torch

    from benchmark.counts.flops import counted
    from benchmark.reference import api
    from benchmark.reference.device import set_precision

    set_precision(tf32)
    flops = None
    try:
        cfg = reference_config(cell)
        model = api.make_model(cfg, draw_weights(reference_shapes(cfg), seeds.stream(
            seed, "weights"), device), device)
        answers = {}
        for i in sorted(set(indices)):
            if count_flops and flops is None:
                answers[i], flops = counted(lambda: api.serve_pair(model, pairs[i][0], pairs[i][1]))
            else:
                answers[i] = api.serve_pair(model, pairs[i][0], pairs[i][1])
    finally:
        set_precision(False)
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return answers, flops


def reference_config(cell):
    from benchmark.reference import api

    scales = cell.traffic["bucket_scales"]
    if len(scales) != 1:
        raise ValueError("register: the reference serves one bucket")
    return api.make_config(cell.config["config"], scales[0])


def reference_shapes(cfg) -> Dict[str, tuple]:
    import torch

    from benchmark.reference.models.rdmnet import RDMNet

    model = RDMNet(cfg, device=torch.device("meta"))
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def served_fits(cell, device, answers) -> list:
    """The weights of the reference's last LGR fit over each answer's own
    correspondences (float32 products)."""
    from benchmark.reference import api
    from benchmark.reference.device import set_precision

    set_precision(False)
    cfg = reference_config(cell)
    return [api.register_served(cfg, a, device)[1] for a in answers]


def judged(cell, device, program, reference) -> Dict[str, float]:
    """``judge.served_checks`` of the program's answers against the reference's."""
    radius = reference_config(cell).fine_matching.acceptance_radius
    return judge.served_checks(program, reference, served_fits(cell, device, program), radius)


def check(cell, rec, device, state, tf32: bool = False) -> None:
    """The reference over a seeded sample of the window's answers; fills
    ``rec.checks`` (and, traced, the counts the metric readers need)."""
    t_check = time.perf_counter()
    kept = state["kept"]
    answers, flops = reference_answers(cell, rec.seed, device, state["pairs"],
                                       [i for i, _ in kept], tf32, count_flops=rec.trace)
    if any(out is None for _, out in kept):  # an answer that never came
        first = answers[kept[0][0]]
        rec.checks = {k: float("inf") for k in judged(cell, device, [first], [first])}
    else:
        rec.checks = judged(cell, device, [out for _, out in kept], [answers[i] for i, _ in kept])
    rec.checks["requests_failed"] = float(rec.failed)
    note(f"reference over {len(kept)} answers", t_check)
    if rec.trace and state["traced"]:
        from benchmark.counts import bounds
        from benchmark.reference import api

        cfg = reference_config(cell)
        rec.flops_per_item = flops
        knn = {i: bounds.knn_pair_bound_ms(cfg, *api.pyramid(cfg, state["pairs"][i][0],
                                                             state["pairs"][i][1], device))
               for i in sorted(set(state["traced"]))}
        rec.bounds_ms["radius_knn"] = sum(knn[i] for i in state["traced"]) / len(state["traced"])
        rec.bounds_ms["sinkhorn"] = bounds.sinkhorn_pair_bound_ms(cfg)


def control(cell, seed: int, device, requests: int = 600) -> Dict[str, float]:
    """The comparison with the reference in TF32 in the program's place, on
    the sample a window of ``requests`` requests would draw."""
    pairs = pair_pool(cell, seed, device)
    order = request_order(len(pairs), seed, requests)
    kept = Reservoir(cell.traffic["check_requests"], seeds.rng(seed, "sample"))
    for i in range(requests):
        kept.offer(int(order[i]))
    wanted = kept.items
    f32, _ = reference_answers(cell, seed, device, pairs, wanted, tf32=False)
    tf32, _ = reference_answers(cell, seed, device, pairs, wanted, tf32=True)
    checks = judged(cell, device, [tf32[i] for i in wanted], [f32[i] for i in wanted])
    checks["requests_failed"] = 0.0  # every request of the control is answered
    return checks
