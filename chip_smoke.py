#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rdmnet_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: a CUDA card is required; prints its name and power limit;
2. build: both kernels from ``rdmnet_tpu_torch/csrc`` with ``nvcc``, in
   parallel, with the ``-Xptxas -v`` register/spill report (no spills);
3. kernels against their plain PyTorch versions at the main path's shapes:
   the 12 radius searches of one pair's graph build (plus the unbanded
   level-0 searches and a level-0 search over duplicated points, whose
   distance ties must come out in index order), and Sinkhorn at P=256,
   K1=129, 100 iterations with masked patches and rows; each kernel's device
   time (CUDA-graph replay) and time per wrapper call (CUDA events around
   eager calls) beside its bound, its launch plan and the time per call of
   the kernels' first design (v1);
4. the main path at ``make_cfg()`` full width, 0.7 bucket: a seeded ~20k
   point procedural pair through ``pipeline`` (graph build to pose), 3
   warm-up pairs, 12 timed pairs, 5 pairs with a per-stage breakdown; every
   kernel must have launched inside that window;
5. the same weights and inputs on the card and on the CPU at
   ``make_tiny_cfg()``, for 8 weight draws: every index table equal, log
   transport plans within 1e-3, LGR on the same plans with equal
   correspondence sets and per-patch hypothesis residuals within 1e-4 m,
   and poses within 1e-4 for the draws that register the pair;
6. the training path at ``make_cfg()`` full width, 0.7 bucket, on the
   phase-4 pair with its true pose: ``batch_to_device`` then
   ``make_train_step`` (forward with ground truth, the seven losses,
   backward, Adam), 2 warm-up and 8 timed steps with each part synchronised,
   the peak memory and every step's losses (finite, ``grad_norm`` > 0, the
   weights move); 12 kNN and 0 Sinkhorn launches per step (training runs the
   plain Sinkhorn under autograd); then one eval step (PIR, IR, RRE, RTE, RR)
   with 12 kNN launches and 1 Sinkhorn launch;
7. one tiny-config train step on the card and on the CPU with the same
   weights, for 3 weight draws, on a pair whose ground-truth target set fits
   ``num_targets`` (so both sample all of it): losses within 1e-4, gradients
   within 1e-2 of each tensor's norm plus 1e-6 of the global norm (2e-3
   globally), weights after the step within 1e-7 where the gradient stands
   clear of float noise and within one step (lr) elsewhere;
8. serving at ``make_cfg()`` full width: ``export_inference`` with buckets
   (0.5, 0.7, 1.0) into a temporary directory, ``load_exported`` on the card
   (the load must allocate one set of weights, ~101 MB, shared by the
   buckets), ``make_handler`` on a ``ThreadingHTTPServer`` at 127.0.0.1 in a
   thread; seeded procedural pairs of ~13k, ~20k and ~28k points and one
   above the largest capacity (truncated) posted over HTTP: every response
   equal to a direct ``serve`` call (pose within 1e-6, the same number of
   correspondences) and to ``pipeline`` on the model at that bucket's
   config, 12 kNN and 1 Sinkhorn launches per request, ``/healthz`` counting
   every request per bucket, a malformed body answered 400 with the server
   still up; for each of these requests, both kernels against their plain
   versions at that bucket's shapes: the 12 searches of the request's graph
   build at the bucket's caps, bands and launch plans (tables equal), and
   Sinkhorn on the request's own inputs (against a float64 run of the
   plain version: within 1e-4 + 1e-4 of each entry's magnitude, or no
   further than twice the float32 plain version); per bucket, after
   warm-up, the ms per request over HTTP, per direct call, per direct call
   on a new thread and per ``pipeline`` call on the padded pair already on
   the card, timed in turns, with their spread; the ms per request of the
   HTTP layer alone (a server answering with stored outputs); the peak
   memory; and the kernel time of one profiled request;
9. RANSAC on the card: 2048 correspondences under a known pose with noise
   and 60% outliers, the same uniforms on the card and on the CPU
   (transforms within 1e-5, the pose within 1e-3 of the known one), and the
   ms of ``ransac_registration_host`` for 50,000 iterations;
10. the train -> snapshot -> test -> eval workflow at ``make_cfg()`` full
   width, 0.7 bucket, on a KITTI-layout root of procedural scans written
   into a temporary directory (train sequence 00 of 5 frames, val 06 and
   test 08 of 3, ~20k points per scan): ``cli.trainval.main`` for 2 epochs
   (8 steps, 4 validation pairs), then again with ``--resume`` for a third
   (the resumed state equal to the saved one bit for bit, 3 train and 3 val
   records, every loss finite, the best snapshot the best val record);
   ``cli.test.main`` on the best snapshot with buckets 0.7/1.0 (each dump
   equal to ``make_forward`` + ``trim_outputs`` at its bucket); ``cli.eval.main``
   with lgr, svd and ransac on the card (the JAX CLI's JSON keys, 2 pairs,
   finite numbers); 12 kNN and 0 Sinkhorn launches per train step, 12 and 1
   per validation and test pair. Prints the Trainer's windowed steps/s beside
   phase 6's isolated step, the loader-wait share of each epoch, validation
   ms per pair, snapshot save/restore ms and size, test ms per pair (prep,
   proc, the ``.npz`` write alone, wall) and eval ms per pair per method;
11. the model surface at ``make_cfg()`` width, 0.7 bucket, on the phase-4
   pair: ``make_parity_cfg()`` with a random kernel disposition per KPConv
   layer, its 12 searches (9 at K 63-81, 3 at K = 1) against the plain
   version with device and per-call ms beside the bound, ``pipeline`` ms per
   pair, per-stage ms and peak memory with 12 kNN and 1 Sinkhorn launches per
   pair; level-0 searches at K = 81 and K = 256 (the 128- and 256-entry
   lists) against the plain version; an upstream-schema ``.pth.tar`` of the
   parity model converted on load (``--torch_checkpoint``'s path) against the
   same weights carried by ``params_from_jax`` (poses within 1e-6); then for
   GeoTransformer, APE, ThDRoFormer with ``k2=(0.5,) * 4`` and the model
   without the vote layer: ``pipeline`` ms per pair and peak memory (12/1
   launches per pair), 3 train steps (finite losses and gradient, 12/0
   launches per step, peak memory), and card against CPU at
   ``make_tiny_cfg()`` for 2 weight draws (tables and node masks equal, the
   same matched node pairs, plans within 1e-3).

Phase 2 fails if ``-Xptxas -v`` reports a spilled register in any kernel.
Prints a ``kernels`` JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

SEED = 7351
WEIGHT_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)  # weight draws of the card-vs-CPU phase (phase 5)
TRAIN_SEEDS = (1, 2, 3)                  # weight draws of the training card-vs-CPU phase (7)
TRAIN_WARM, TRAIN_TIMED = 2, 8           # train steps of phase 6
SERVE_SCALES = (0.5, 0.7, 1.0)           # capacity buckets of phase 8
SERVE_SIZES = (13000, 20000, 28000)      # points per cloud of phase 8's pairs, one per bucket
SERVE_WARM, SERVE_TIMED = 3, 15          # requests per bucket of phase 8
HTTP_LAYER_TIMED = 40                    # requests per bucket to phase 8's HTTP-layer server
RANSAC_ITERATIONS = 50000                # phase 9
# phase 10: (scene seed, frames) per sequence of the KITTI-layout root
WORKFLOW_SEQUENCES = {0: (SEED + 10, 5), 6: (SEED + 11, 3), 8: (SEED + 12, 3)}
WORKFLOW_SCAN = dict(n_rings=80, n_azimuths=3000, step=10.0)
# the JAX CLI's --json_out keys (rdmnet_tpu/cli/eval.py)
EVAL_JSON_KEYS = {"method", "n_pairs", "RR", "RRE_deg", "RTE_m", "PIR", "IR", "overlap",
                  "failed_pairs", "per_pair"}
LGR_INPUTS = ("ref_node_corr_knn_points", "src_node_corr_knn_points", "ref_node_corr_knn_masks",
              "src_node_corr_knn_masks", "matching_scores", "node_corr_valid")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
SFU_PER_SM_CLK = 16           # exp2 throughput per SM per clock (compute capability 9.0)
NUM_SMS = 132
KNN_OPS_PER_PAIR = 9          # 3 FMA (2 each), sub, add, max per (query, candidate)
SINKHORN_OPS_PER_ENTRY = 4    # add, max, sub, add per entry and half-step (beside one exp)
DESIGN = "v2"                 # the kernels' design in csrc/, as PERF.md names it
# ms per wrapper call of the kernels' first design, v1 (one thread per query with
# a local-memory top-K; warp-per-row Sinkhorn in shared memory), on an NVIDIA H100
# 80GB HBM3 at 700.00 W: the mean of two runs of the v1 tree's chip_smoke.py in
# one call (PERF.md, section 6, the v2 redesign). Keys are (table, query level,
# support level, k).
V1_KNN_MS = {
    ("neighbors", 0, 0, 40): 1.2344, ("subsampling", 1, 0, 40): 1.7591,
    ("neighbors", 1, 1, 40): 1.0634, ("subsampling", 2, 1, 40): 1.7496,
    ("upsampling", 1, 2, 1): 0.0551, ("neighbors", 2, 2, 40): 0.9172,
    ("subsampling", 3, 2, 40): 1.5240, ("upsampling", 2, 3, 1): 0.0397,
    ("neighbors", 3, 3, 40): 0.8292, ("subsampling", 4, 3, 40): 1.2368,
    ("upsampling", 3, 4, 1): 0.0383, ("neighbors", 4, 4, 40): 0.5811,
    ("unbanded", 0, 0, 40): 2.5537, ("unbanded", 0, 0, 1): 0.6676,
}
V1_SINKHORN_MS = 2.5560


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's per-call work is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def knn_diagnosis(q, s, got, want, rows: int = 3):
    """Lines describing the first ``rows`` rows where the kernel's table
    differs from the plain version's: each side's neighbours with their
    float64 squared distances (printed when the check fails)."""
    import torch

    ns = s.shape[1]
    lines = []
    for b, r in (got != want).any(dim=-1).nonzero().tolist()[:rows]:
        qd = q[b, r].double()
        for side, idx in (("kernel", got[b, r]), ("plain", want[b, r])):
            valid = idx[idx < ns].long()
            d = ((s[b, valid].double() - qd) ** 2).sum(-1)
            lines.append(f"  cloud {b} query {r} {side}: "
                         + ", ".join(f"{i}:{x:.6f}" for i, x in zip(valid.tolist(), d.tolist())))
    return lines


def hypothesis_residuals(corr):
    """Per-patch Procrustes hypotheses of an LGR correspondence set, as LGR
    forms them: each hypothesis's weighted mean residual on its own patch
    (m) and the patch's number of correspondences."""
    import torch

    from rdmnet_tpu_torch.ops.geometry import apply_transform
    from rdmnet_tpu_torch.ops.procrustes import weighted_procrustes

    p = int(corr.patch_ids.max()) + 1
    src, ref = corr.src_points.reshape(p, -1, 3), corr.ref_points.reshape(p, -1, 3)
    w = corr.scores.reshape(p, -1)
    hyp = weighted_procrustes(src, ref, w)
    res = torch.linalg.norm(ref - apply_transform(src, hyp), dim=-1)
    return (res * w).sum(-1) / (w.sum(-1) + 1e-12), (w > 0).sum(-1)


def check_knn(pts, cnts, sp, kernels):
    """Kernel vs plain for one search ``sp`` (a ``SearchSpec``) of the graph
    build on the card."""
    import torch

    from rdmnet_tpu_torch.ops.kernels.radius_knn import knn_plan, radius_knn_cuda, radius_knn_plain
    from rdmnet_tpu_torch.ops.radius_search import band_windows

    q, s, scnt = pts[sp.q_lvl], pts[sp.s_lvl], cnts[sp.s_lvl]
    plan = knn_plan(q.shape[0], q.shape[1], s.shape[1], sp.k, sp.band)
    kw = {}
    if sp.band is not None:
        win, _ = band_windows(q, s, cnts[sp.q_lvl], sp.radius, sp.cell, sp.band, sp.chunk)
        kw = dict(win=win, chunk=sp.chunk, band=sp.band)
    got = radius_knn_cuda(q, s, scnt, sp.radius, sp.k, **kw)
    torch.cuda.synchronize()
    want = radius_knn_plain(q, s, scnt, sp.radius, sp.k, **kw)
    # exact: the kernel's FMA chain and (distance, index) order are the plain
    # version's, so even ties must come out the same
    differ = (got != want).any(dim=-1)
    if bool(differ.any()):
        print("\n".join(knn_diagnosis(q, s, got, want)), file=sys.stderr)
        fail(f"radius_knn {sp.table}[{sp.q_lvl}->{sp.s_lvl}] k={sp.k}: {int(differ.sum())} "
             "rows differ from the plain version")
    err = float((got.long() - want.long()).abs().max())
    call = lambda: radius_knn_cuda(q, s, scnt, sp.radius, sp.k, **kw)  # noqa: E731
    ms, call_ms = graph_ms(call, reps=10), cuda_ms(call, reps=10)
    plain_ms = cuda_ms(lambda: radius_knn_plain(q, s, scnt, sp.radius, sp.k, **kw), reps=1,
                       warmup=0)
    # work this run's data needs: valid queries x valid candidates in their window
    pairs = 0
    bsz, nq, _ = q.shape
    qcnt = cnts[sp.q_lvl].tolist()
    for b in range(bsz):
        c = int(scnt[b])
        if sp.band is None:
            pairs += qcnt[b] * c
            continue
        for ci, w in enumerate(kw["win"][b].tolist()):
            nvq = max(0, min(qcnt[b], (ci + 1) * sp.chunk) - ci * sp.chunk)
            pairs += nvq * max(0, min(w + sp.band, c) - w)
    nbytes = bsz * (nq * 3 * 4 + s.shape[1] * 3 * 4 + nq * sp.k * 4)
    bound = max(nbytes / HBM_BYTES_PER_S, pairs * KNN_OPS_PER_PAIR / F32_FLOPS) * 1e3
    kernels["radius_knn"]["max_abs_err"] = max(kernels["radius_knn"]["max_abs_err"], err)
    return ms, call_ms, plain_ms, bound, pairs, plan


def knn_line(name: str, ms, call_ms, pms, bound, plan, v1) -> str:
    p = (f"plan warps={plan.warps} k_bucket={plan.k_bucket} tile_rows={plan.tile_rows} "
         f"tiled={plan.tiled} smem={plan.smem_bytes}")
    old = "not recorded" if v1 is None else f"{v1:.4f} ms per call"
    return (f"radius_knn {name}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms per call, "
            f"v1 design {old}; plain {pms:.3f} ms, bound {bound:.5f} ms; {p}")


def pair_levels(batch, num_stages):
    """Per-level points (2, N, 3) and counts (2,) of a pair batch, ref and src
    stacked as the kNN wrapper takes them."""
    import torch

    pts = [torch.stack([batch.ref.points[i], batch.src.points[i]]).contiguous()
           for i in range(num_stages)]
    cnts = [torch.stack([batch.ref.counts[i], batch.src.counts[i]]).to(torch.int32)
            for i in range(num_stages)]
    return pts, cnts


def check_searches(pts, cnts, pyramid, kernels, prefix="", v1=None):
    """``check_knn`` over the 12 searches of ``pyramid``'s graph build, one
    line each. Returns the summed (device ms, ms per call, plain ms, bound ms)."""
    from rdmnet_tpu_torch.graph.pyramid import search_plan

    total = [0.0, 0.0, 0.0, 0.0]
    for item in search_plan(pyramid):
        ms, call_ms, pms, bound, pairs, plan = check_knn(pts, cnts, item, kernels)
        total = [a + b for a, b in zip(total, (ms, call_ms, pms, bound))]
        name = (f"{prefix}{item.table}[{item.q_lvl}->{item.s_lvl}] Q={pts[item.q_lvl].shape[1]} "
                f"S={pts[item.s_lvl].shape[1]} K={item.k} band={item.band}")
        print(knn_line(name, ms, call_ms, pms, bound, plan,
                       (v1 or {}).get((item.table, item.q_lvl, item.s_lvl, item.k)))
              + f"; candidate pairs {pairs}")
    return total


def train_phase(cfg, host, dev):
    """Phase 6: ``TRAIN_WARM`` + ``TRAIN_TIMED`` train steps on ``host`` (a
    one-pair host batch), each part synchronised, then one eval step. Returns
    the printed summary's numbers and the launch counts."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.engine import (TRAIN_STAGES, batch_to_device, create_train_state,
                                         make_eval_step, make_train_step)
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    state = create_train_state(cfg, RDMNet(cfg, device=dev,
                                           generator=torch.Generator().manual_seed(SEED)))
    step = make_train_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = [p.detach().clone() for p in state.params]
    parts = {name: 0.0 for name in TRAIN_STAGES}
    train_counts = {name: 0 for name in launch_counts()}
    step_ms = []
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        if i == TRAIN_WARM:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        marks = []

        def hook(name):
            torch.cuda.synchronize(dev)
            marks.append((name, time.perf_counter()))

        reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        batch = batch_to_device(host, cfg.pyramid, device=dev)
        hook("build")
        state, metrics = step(state, batch, gen, stage_hook=hook)
        counts = launch_counts()
        metrics = {k: float(v) for k, v in metrics.items()}
        if counts != {"radius_knn": 12, "sinkhorn": 0}:
            fail(f"train step {i}: launches {counts}, expected 12 kNN and 0 Sinkhorn")
        if not all(np.isfinite(v) for v in metrics.values()) or metrics["grad_norm"] <= 0:
            fail(f"train step {i}: non-finite losses or zero gradient: {metrics}")
        for name in counts:
            train_counts[name] += counts[name]
        kind = "warm-up" if i < TRAIN_WARM else "timed"
        print(f"train step {i} ({kind}): {(marks[-1][1] - t0) * 1e3:.3f} ms, "
              + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()))
        if i >= TRAIN_WARM:
            step_ms.append((marks[-1][1] - t0) * 1e3)
            prev = t0
            for name, t in marks:
                parts[name] += (t - prev) * 1e3 / TRAIN_TIMED
                prev = t
    peak = torch.cuda.max_memory_allocated(dev)
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(state.params, start))
    if state.count != TRAIN_WARM + TRAIN_TIMED or moved <= 0:
        fail(f"training: {state.count} updates applied, weights moved by {moved}")

    # one more step under the profiler: device time by operation and the
    # device's busy share of the step's wall time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch_to_device(host, cfg.pyramid, device=dev), gen)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels are the events on the device; operators (host events) carry
    # the device time of the kernels they launched, so they are listed, not summed
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    print(f"profiled train step: {wall_ms:.3f} ms wall, {device_ms:.3f} ms of kernel time on "
          f"the device ({100 * device_ms / wall_ms:.1f}% busy under the profiler); top "
          "operators by the device time of their kernels:")
    for e in ops[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")

    reset_launch_counts()
    batch = batch_to_device(host, cfg.pyramid, device=dev)
    ev, tfs = make_eval_step(cfg, device=dev)(state, batch)
    eval_counts = launch_counts()
    ev = {k: float(v) for k, v in ev.items()}
    if eval_counts != {"radius_knn": 12, "sinkhorn": 1}:
        fail(f"eval step: launches {eval_counts}, expected 12 kNN and 1 Sinkhorn")
    if not all(np.isfinite(v) for v in ev.values()) or tfs.shape != (1, 4, 4):
        fail(f"eval step: non-finite metrics {ev} or transforms of shape {tuple(tfs.shape)}")
    return dict(step_ms=step_ms, parts=parts, peak=peak, moved=moved, eval=ev,
                train_counts=train_counts, eval_counts=eval_counts, busy=device_ms / wall_ms)


def train_card_vs_cpu(cfg, host, dev):
    """Phase 7: one train step per weight draw of ``TRAIN_SEEDS`` on ``dev``
    and on the CPU, held to the tolerances of the module docstring."""
    import torch

    from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
    from rdmnet_tpu_torch.models import RDMNet

    lr = cfg.optim.lr
    for seed in TRAIN_SEEDS:
        runs = []
        for d in (dev, torch.device("cpu")):
            state = create_train_state(cfg, RDMNet(cfg, device=d,
                                                   generator=torch.Generator().manual_seed(seed)))
            batch = batch_to_device(host, cfg.pyramid, device=d)
            with torch.no_grad():
                overlaps = state.model(batch[0], training=False, with_gt=True)["gt_node_corr_overlaps"]
            eligible = int((overlaps > cfg.coarse_matching.overlap_threshold).sum())
            if not 0 < eligible <= cfg.coarse_matching.num_targets:
                fail(f"train card vs CPU (weights {seed}): {eligible} eligible targets, the "
                     f"check needs 1..{cfg.coarse_matching.num_targets}")
            metrics, grads = make_value_and_grad(cfg, device=d)(
                state, batch, torch.Generator(device=d).manual_seed(0))
            before = [p.detach().cpu().clone() for p in state.params]
            if not state.apply_gradients(grads):
                fail(f"train card vs CPU (weights {seed}): the update was skipped on {d}")
            runs.append(({k: float(v) for k, v in metrics.items()}, [g.cpu() for g in grads],
                         before, [p.detach().cpu().clone() for p in state.params], eligible))
        (m_g, g_g, p0_g, p1_g, e_g), (m_c, g_c, p0_c, p1_c, e_c) = runs
        loss_err = max(abs(m_g[k] - m_c[k]) for k in m_c if k != "grad_norm")
        total = float(torch.sqrt(sum((g * g).sum() for g in g_c)))
        glob = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(g_g, g_c)))) / total
        gmax = max(float(g.abs().max()) for g in g_c)
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        worst, worst_name, p_err, step_max = 0.0, "", 0.0, 0.0
        for name, a, b, q0g, q0c, q1g, q1c in zip(names, g_g, g_c, p0_g, p0_c, p1_g, p1_c):
            if not torch.equal(q0g, q0c):
                fail(f"train card vs CPU (weights {seed}): the initial weights differ")
            ratio = float(torch.linalg.norm(a - b)) / (1e-2 * float(torch.linalg.norm(b))
                                                       + 1e-6 * total)
            if ratio > worst:
                worst, worst_name = ratio, name
            sig = b.abs() > 1e-3 * gmax
            if bool(sig.any()):
                p_err = max(p_err, float((q1g - q1c)[sig].abs().max()))
            step_max = max(step_max, float((q1g - q0g).abs().max()))
        print(f"train card vs CPU (tiny cfg, weights {seed}): eligible targets {e_g}/{e_c} of "
              f"{cfg.coarse_matching.num_targets}; losses max abs diff {loss_err:.3e}; gradients "
              f"{glob:.3e} of the global norm, worst tensor {worst_name} at {worst:.3f} of its "
              f"bound; weights after the step {p_err:.3e} where the gradient is clear of noise, "
              f"largest step {step_max:.3e} (lr {lr})")
        if e_g != e_c or loss_err > 1e-4 or glob > 2e-3 or worst > 1.0 or p_err > 1e-7 \
                or step_max > lr * (1 + 1e-3):
            fail(f"train card vs CPU (weights {seed}): outside the tolerances")


def host_pair(ref, src, transform, cap):
    """One padded pair as the host batch ``batch_to_device`` takes."""
    import numpy as np

    from rdmnet_tpu_torch.graph.pyramid import pad_cloud

    (rp, rc), (sp, sc) = pad_cloud(ref, cap), pad_cloud(src, cap)
    return {"ref_points": rp.numpy()[None], "ref_counts": rc.numpy()[None],
            "src_points": sp.numpy()[None], "src_counts": sc.numpy()[None],
            "transform": np.asarray(transform, np.float32)[None]}


def post(url, body):
    """(status, body bytes) of one POST."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def spread(ms):
    ms = sorted(ms)
    return (f"mean {sum(ms) / len(ms):.3f}, median {ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, "
            f"max {ms[-1]:.3f}")


def serve_checked(serve, r, s, kernels):
    """One direct ``serve`` call whose Sinkhorn inputs are kept and run again
    through the plain version, in float32 and in float64. On the entries that
    are not masked, the kernel's log plan must lie within the card tests'
    tolerance, 1e-4 + 1e-4 * |x|, of the float64 run, or no further from it
    than twice the float32 plain version does: a model's scores reach
    magnitudes of a few hundred, where 100 iterations of float32 rounding
    alone can leave the tolerance. Returns the call's outputs."""
    import torch

    ot = serve.model.optimal_transport  # shared by every bucket's view
    seen = []
    handle = ot.register_forward_hook(
        lambda mod, args, kwargs, out: seen.append((args, kwargs, out)), with_kwargs=True)
    try:
        direct = serve(r, s)
    finally:
        handle.remove()
    (args, kwargs, got), = seen
    if not kwargs.get("use_kernel", True):
        fail("serving: the served request did not take the Sinkhorn kernel")
    with torch.no_grad():
        want = ot(*args, use_kernel=False)
        exact = ot(args[0].double(), *args[1:], use_kernel=False)
    live = want > -1e11
    if not torch.isfinite(got).all() or not torch.equal(got > -1e11, live):
        fail("serving: Sinkhorn kernel output non-finite or masked entries differ")
    ref = exact[live]
    tol = 1e-4 + 1e-4 * ref.abs()
    worst_k = float(((got[live] - ref).abs() / tol).max())
    worst_p = float(((want[live] - ref).abs() / tol).max())
    err = float((got - want)[live].abs().max())
    kernels["sinkhorn"]["max_abs_err"] = max(kernels["sinkhorn"]["max_abs_err"], err)
    print(f"serving: sinkhorn on the request's own inputs {tuple(args[0].shape)}: max abs err "
          f"{err:.3e} against the plain version; against the float64 run (entries up to "
          f"{float(ref.abs().max()):.3f} in magnitude) the kernel's worst entry is at "
          f"{worst_k:.3f} of the tolerance, the float32 plain version's at {worst_p:.3f}")
    if worst_k > max(1.0, 2.0 * worst_p):
        fail("serving: sinkhorn outside its tolerance on a served request's inputs")
    return direct


def serving_phase(dev, card, kernels):
    """Phase 8: export, load on the card, serve over HTTP at every bucket.
    Returns the launches per served request by kernel."""
    import numpy as np
    import torch
    from http.server import ThreadingHTTPServer

    from rdmnet_tpu_torch.cli.serve import make_handler
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.data.procedural import procedural_pair
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud
    from rdmnet_tpu_torch.models import RDMNet, pipeline, with_pyramid
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.data.loader import pad_points_np
    from rdmnet_tpu_torch.serving import export_inference, load_exported

    cfg = make_cfg()
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    resident = sum(t.numel() * t.element_size()
                   for t in list(model.parameters()) + list(model.buffers()))
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        buckets = export_inference(cfg, model, out_dir, bucket_scales=SERVE_SCALES)
        export_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        serve, meta = load_exported(out_dir)
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        loaded = torch.cuda.memory_allocated(dev) - before
    del model
    caps = [b["cap"] for b in buckets]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in list(serve.model.parameters()) + list(serve.model.buffers())}
    print(f"serving: exported {n_params} parameters ({meta['n_weights']} arrays) for buckets "
          f"{caps} in {export_s:.3f} s, loaded in {load_s:.3f} s; the load allocated "
          f"{loaded / 1e6:.3f} MB on the card for {resident / 1e6:.3f} MB of parameters and "
          f"buffers, held in {len(storages)} device storages of {sum(storages.values()) / 1e6:.3f} "
          "MB")
    if serve.model.device.type != "cuda" or not resident <= loaded < 1.5 * resident:
        fail(f"serving: the load allocated {loaded} bytes for {resident} bytes of weights "
             "(one shared copy expected)")

    # ~13k / ~20k / ~28k points per cloud from one dense procedural pair, and the
    # whole pair (above the largest capacity: truncated)
    ref, src, _ = procedural_pair(SEED, n_rings=192, n_azimuths=6000)
    if min(len(ref), len(src)) <= caps[-1]:
        fail(f"serving: the dense pair has {len(ref)}/{len(src)} points, not above {caps[-1]}")
    pick = np.random.RandomState(SEED)
    pairs = [(ref[pick.permutation(len(ref))[:n]], src[pick.permutation(len(src))[:n]])
             for n in SERVE_SIZES] + [(ref, src)]

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(serve, meta))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    served, expected = {name: 0 for name in launch_counts()}, {}
    n_requests = 0
    try:
        for (r, s), want_cap in zip(pairs, caps + [caps[-1]]):
            buf = io.BytesIO()
            np.savez(buf, ref_points=r, src_points=s)
            body = buf.getvalue()
            # the checked request: over HTTP, launches counted around it alone
            reset_launch_counts()
            status, data = post(url + "/register", body)
            counts = launch_counts()
            n_requests += 1
            expected[str(want_cap)] = expected.get(str(want_cap), 0) + 1
            if status != 200:
                fail(f"serving: HTTP {status} for a {len(r)}-point pair: {data[:200]!r}")
            if counts != {"radius_knn": 12, "sinkhorn": 1}:
                fail(f"serving: launches {counts} for one request, expected 12 kNN and 1 Sinkhorn")
            for name, n in counts.items():
                served[name] += n
            resp = dict(np.load(io.BytesIO(data)))
            direct = serve_checked(serve, r, s, kernels)
            if serve.last_cap != want_cap:
                fail(f"serving: a {len(r)}-point pair went to bucket {serve.last_cap}, "
                     f"expected {want_cap}")
            bucket = next(b for b in buckets if b["cap"] == want_cap)
            # the kNN kernel against its plain version at this bucket's shapes
            # and launch plans, on the graph of this request's pair
            pyr = bucket["cfg"].pyramid
            kb = build_pair_batch(*pad_cloud(r, want_cap, device=dev),
                                  *pad_cloud(s, want_cap, device=dev),
                                  torch.eye(4, device=dev), pyr)
            check_searches(*pair_levels(kb, pyr.num_stages), pyr, kernels,
                           prefix=f"bucket {want_cap} ({len(r)} points) ")
            rp, rc = pad_points_np(r, want_cap)
            sp, sc = pad_points_np(s, want_cap)
            live = pipeline(with_pyramid(serve.model, bucket["cfg"].pyramid), rp, rc, sp, sc,
                            device=dev)
            live_tf = live["estimated_transform"].cpu().numpy()
            n_corr = int((direct["corr_scores"] > 0).sum())
            est = direct["estimated_transform"]
            http_err = float(np.abs(resp["estimated_transform"] - est).max())
            live_err = float(np.abs(live_tf - est).max())
            n_live = int((live["corr_scores"] > 0).sum())
            print(f"serving: {len(r)}/{len(s)} points -> bucket {want_cap}: {n_corr} "
                  f"correspondences; HTTP vs direct pose {http_err:.3e}, "
                  f"{len(resp['corr_scores'])} correspondences; pipeline vs direct pose "
                  f"{live_err:.3e}, {n_live} correspondences; launches {counts}")
            if http_err > 1e-6 or len(resp["corr_scores"]) != n_corr:
                fail("serving: the HTTP response differs from the direct call")
            if live_err > 1e-6 or n_live != n_corr or not np.isfinite(live_tf).all():
                fail("serving: the direct call differs from pipeline at the bucket's config")

        status, data = post(url + "/register", b"not an npz")
        if status != 400:
            fail(f"serving: a malformed body got HTTP {status}, expected 400")
        health = get_json(url + "/healthz")
        print(f"serving: /healthz after a malformed body: requests {health['requests']}, "
              f"errors {health['errors']}, per bucket {health['bucket_requests']}")
        if (health["requests"], health["errors"]) != (n_requests, 1) \
                or health["bucket_requests"] != expected:
            fail(f"serving: /healthz counts {health}, expected {n_requests} requests, 1 error, "
                 f"{expected}")

        # time each bucket on its pair, after warm-up: HTTP requests, direct
        # calls, direct calls on a new thread (as the server runs each
        # request) and pipeline on the padded pair already on the card, in
        # turns with the order rotating (the host's noise drifts)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        # the HTTP layer alone: a second server whose serve function returns
        # the bucket's stored outputs, so its time holds no device work and
        # none of the device path's host noise
        stored = {}
        stub = lambda _r, _s: stored["out"]  # noqa: E731
        stub_server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(stub, meta))
        stub_thread = threading.Thread(target=stub_server.serve_forever, daemon=True)
        stub_thread.start()
        stub_url = f"http://127.0.0.1:{stub_server.server_address[1]}/register"
        kinds = ("http", "direct", "thread", "pipeline")
        for (r, s), b in zip(pairs, buckets):
            cap = b["cap"]
            buf = io.BytesIO()
            np.savez(buf, ref_points=r, src_points=s)
            body = buf.getvalue()
            view = with_pyramid(serve.model, b["cfg"].pyramid)
            padded = [torch.as_tensor(x, device=dev)
                      for x in (*pad_points_np(r, cap), *pad_points_np(s, cap))]
            for _ in range(SERVE_WARM):
                post(url + "/register", body)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            resident_now = torch.cuda.memory_allocated(dev)
            ms = {kind: [] for kind in kinds}
            for i in range(SERVE_TIMED):
                for kind in kinds[i % 4:] + kinds[:i % 4]:
                    t0 = time.perf_counter()
                    if kind == "http":
                        status, _ = post(url + "/register", body)
                        if status != 200:
                            fail(f"serving: HTTP {status} while timing bucket {cap}")
                    elif kind == "direct":
                        serve(r, s)
                    elif kind == "thread":
                        with ThreadPoolExecutor(max_workers=1) as worker:
                            worker.submit(serve, r, s).result()
                    else:
                        pipeline(view, *padded, device=dev)
                        torch.cuda.synchronize(dev)
                    ms[kind].append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated(dev)
            # one more direct call under the profiler: kernel time against wall time
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                serve(r, s)
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            and not getattr(e, "is_user_annotation", False)) / 1e3
            diff = {k: sorted(a - c for a, c in zip(ms[k], ms[base]))
                    for k, base in (("http", "direct"), ("thread", "direct"),
                                    ("direct", "pipeline"))}
            stored["out"] = serve(r, s)
            layer_ms = []
            for i in range(SERVE_WARM + HTTP_LAYER_TIMED):
                t0 = time.perf_counter()
                status, _ = post(stub_url, body)
                if status != 200:
                    fail(f"serving: HTTP {status} from the HTTP-layer server")
                if i >= SERVE_WARM:
                    layer_ms.append((time.perf_counter() - t0) * 1e3)
            print(f"serving bucket {cap} ({len(r)}/{len(s)} points), {SERVE_TIMED} turns after "
                  f"{SERVE_WARM} warm-up requests, {card}:\n"
                  f"  HTTP ms/request {spread(ms['http'])}\n"
                  f"  direct ms/call {spread(ms['direct'])}\n"
                  f"  direct ms/call on a new thread {spread(ms['thread'])}\n"
                  f"  pipeline ms/pair on the padded pair on the card {spread(ms['pipeline'])}\n"
                  f"  serving overhead per turn: HTTP - direct {spread(diff['http'])}; thread - "
                  f"direct {spread(diff['thread'])}; direct - pipeline {spread(diff['direct'])}\n"
                  f"  HTTP layer alone (stored outputs, {len(body)} request bytes), "
                  f"{HTTP_LAYER_TIMED} requests: ms/request {spread(layer_ms)}\n"
                  f"  peak memory {peak / 2**20:.1f} MiB ({resident_now / 2**20:.1f} MiB resident "
                  f"before the requests); profiled direct call {wall_ms:.3f} ms wall, "
                  f"{kernel_ms:.3f} ms of kernel time ({100 * kernel_ms / wall_ms:.1f}% busy under "
                  "the profiler)")
        final = get_json(url + "/healthz")
        if final["requests"] != n_requests + len(caps) * (SERVE_WARM + SERVE_TIMED):
            fail(f"serving: /healthz counted {final['requests']} requests")
        stub_server.shutdown()
        stub_server.server_close()
        stub_thread.join(timeout=60)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return {name: n / n_requests for name, n in served.items()}


def ransac_phase(dev, card):
    """Phase 9: RANSAC on the card against the CPU on the same uniforms, the
    known pose recovered, and the time of 50,000 iterations."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.ransac import (ransac_capacity, ransac_registration,
                                             ransac_registration_host)
    from rdmnet_tpu_torch.utils.se3_np import get_transform_from_rotation_translation

    rng = np.random.RandomState(SEED)
    n, n_in = 2048, 820  # 60% outliers
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    tf = get_transform_from_rotation_translation(rot, rng.randn(3) * 3)
    src = ((rng.rand(n, 3) - 0.5) * 40).astype(np.float32)
    ref = (src @ rot.T + tf[:3, 3] + (rng.rand(n, 3) - 0.5) * 0.02).astype(np.float32)
    ref[n_in:] = (rng.rand(n - n_in, 3) - 0.5) * 40
    cap, chunk = ransac_capacity(n)
    n_chunks = -(-RANSAC_ITERATIONS // chunk)
    u = torch.rand(n_chunks, chunk, 4, generator=torch.Generator().manual_seed(SEED))
    args = [torch.from_numpy(src), torch.from_numpy(ref), torch.ones(n, dtype=torch.bool), u]
    kw = dict(num_iterations=RANSAC_ITERATIONS, chunk=chunk, threshold=0.3)
    with torch.no_grad():
        want = ransac_registration(*args, **kw).numpy()
        got = ransac_registration(*[a.to(dev) for a in args], **kw).cpu().numpy()
    err = float(np.abs(got - want).max())
    pose_err = float(np.abs(got - tf).max())
    ransac_registration_host(src, ref, num_iterations=RANSAC_ITERATIONS)  # warm-up
    ms = []
    for seed in range(5):
        t0 = time.perf_counter()
        host = ransac_registration_host(src, ref, num_iterations=RANSAC_ITERATIONS, seed=seed)
        ms.append((time.perf_counter() - t0) * 1e3)
    host_err = float(np.abs(host - tf).max())
    print(f"ransac: {n} correspondences ({n - n_in} outliers), {n_chunks} chunks of {chunk} "
          f"hypotheses at capacity {cap}; card vs CPU on the same uniforms {err:.3e}; pose vs "
          f"known {pose_err:.3e} (host wrapper {host_err:.3e}); {RANSAC_ITERATIONS} iterations "
          f"in ms: {spread(ms)} ({card})")
    if err > 1e-5 or pose_err > 1e-3 or host_err > 1e-3:
        fail("ransac: outside the tolerances")


def _launch_recorder(events, kind):
    """Wraps a step factory of the port so each step it makes appends (kind,
    the cumulative launch counts after the step) to ``events``."""
    from rdmnet_tpu_torch.ops.kernels import launch_counts

    def wrap(factory):
        def make(*args, **kwargs):
            step = factory(*args, **kwargs)

            def counted(*a, **kw):
                out = step(*a, **kw)
                events.append((kind, launch_counts()))
                return out
            return counted
        return make
    return wrap


def _per_event(events):
    """Launches per event from cumulative counts: each event owns what was
    launched since the one before it (its batch's graph build included)."""
    out, prev = [], {"radius_knn": 0, "sinkhorn": 0}
    for kind, counts in events:
        out.append((kind, {k: counts[k] - prev[k] for k in counts}))
        prev = counts
    return out


def workflow_phase(dev, card, kernels, isolated_step_ms, cli_args=()):
    """Phase 10: train -> snapshot -> test -> eval through the CLIs' ``main``
    on a procedural KITTI-layout root, on ``dev``. ``cli_args`` go to every
    CLI (``--cfg_preset tiny`` rehearses the phase on the CPU). Returns
    launches per trainer step, validation pair and test pair by kernel."""
    import numpy as np
    import torch

    import rdmnet_tpu_torch.cli.test as test_cli
    import rdmnet_tpu_torch.engine.trainer as trainer_mod
    from rdmnet_tpu_torch.cli import eval as eval_cli
    from rdmnet_tpu_torch.cli import trainval
    from rdmnet_tpu_torch.cli.common import (build_model_and_params, make_forward, pad_pair_np,
                                             trim_outputs)
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset, write_procedural_root
    from rdmnet_tpu_torch.data.loader import PairLoader, choose_bucket
    from rdmnet_tpu_torch.engine import create_train_state
    from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager, state_to_host
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.ops.kernels import reset_launch_counts

    def equal_states(a, b, where):
        for part in ("model", "accumulator"):
            for k, v in (a[part] or {}).items():
                if not torch.equal(v, b[part][k]):
                    fail(f"workflow: {where}: {part} {k} differs")
        for name, st in a["optimizer"]["state"].items():
            for k, v in st.items():
                if not torch.equal(v.cpu(), b["optimizer"]["state"][name][k].cpu()):
                    fail(f"workflow: {where}: optimizer {name} {k} differs")
        for k in ("count", "mini_step", "notfinite_count"):
            if a[k] != b[k]:
                fail(f"workflow: {where}: {k} {a[k]} != {b[k]}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cli_args = ["--device", dev.type, *cli_args]
    events, resumed, test_cfgs = [], [], []
    orig = (trainer_mod.make_train_step, trainer_mod.make_eval_step, trainer_mod.Trainer.resume,
            test_cli._make_eval_forward, test_cli.run_eval_loop)
    loop_s = []

    def resume_and_keep(self):
        orig[2](self)
        resumed.append(state_to_host(self.state))

    def test_forward(cfg, *args, **kwargs):
        test_cfgs.append(cfg)
        return _launch_recorder(events, "test")(orig[3])(cfg, *args, **kwargs)

    def timed_loop(*args, **kwargs):
        t0 = time.perf_counter()
        board = orig[4](*args, **kwargs)
        loop_s.append(time.perf_counter() - t0)
        return board

    # the CLIs build these inside their mains: wrapped here to count launches
    # per step and pair, keep the resumed state and time the test loop
    trainer_mod.make_train_step = _launch_recorder(events, "train")(orig[0])
    trainer_mod.make_eval_step = _launch_recorder(events, "val")(orig[1])
    trainer_mod.Trainer.resume = resume_and_keep
    test_cli._make_eval_forward = test_forward
    test_cli.run_eval_loop = timed_loop
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root, run = os.path.join(tmp, "kitti"), os.path.join(tmp, "run")
            t0 = time.perf_counter()
            write_procedural_root(root, "kitti", WORKFLOW_SEQUENCES, **WORKFLOW_SCAN)
            sizes = [len(np.load(os.path.join(root, "downsampled_xyzi", f"{seq:02d}",
                                              f"{i:06d}.npy")))
                     for seq, (_, n) in WORKFLOW_SEQUENCES.items() for i in range(n)]
            print(f"workflow: root of {len(sizes)} procedural scans ({min(sizes)}-{max(sizes)} "
                  f"points) written in {time.perf_counter() - t0:.3f} s")
            argv = ["--root", root, "--output_dir", run, "--bucket_scale", "0.7",
                    "--log_steps", "2", "--keep_snapshots", "1", *cli_args]

            # ---- train 2 epochs, then resume for a third
            reset_launch_counts()
            t0 = time.perf_counter()
            first = trainval.main(argv + ["--max_epoch", "2"])
            train1_s = time.perf_counter() - t0
            saved = torch.load(os.path.join(run, "snapshots", "2", "state.pt"),
                               map_location="cpu", weights_only=True)
            equal_states(state_to_host(first.state), saved, "the saved snapshot")
            t0 = time.perf_counter()
            second = trainval.main(argv + ["--max_epoch", "3", "--resume"])
            train2_s = time.perf_counter() - t0
            if len(resumed) != 1:
                fail("workflow: the resumed run did not resume")
            equal_states(resumed[0], saved, "the resumed state against the snapshot")
            train_events = _per_event(events)
            with open(os.path.join(run, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            phases = [(r["phase"], r["epoch"]) for r in records]
            if phases != [("train", 0), ("val", 0), ("train", 1), ("val", 1), ("train", 2),
                          ("val", 2)]:
                fail(f"workflow: metrics.jsonl records {phases}")
            if not all(np.isfinite(v) for r in records for v in r.values()
                       if isinstance(v, float)):
                fail(f"workflow: non-finite values in metrics.jsonl: {records}")
            best = CheckpointManager(os.path.join(run, "snapshots_best")).read_metadata()
            want_best = max(trainer_mod.Trainer._val_score(r) for r in records
                            if r["phase"] == "val")
            if tuple(best["score"]) != want_best:
                fail(f"workflow: best snapshot score {best['score']}, best val {want_best}")
            if second.snapshots.all_steps() != [3] or second.state.count != 12:
                fail(f"workflow: snapshots {second.snapshots.all_steps()}, "
                     f"{second.state.count} updates")
            for kind, want in (("train", {"radius_knn": 12, "sinkhorn": 0}),
                               ("val", {"radius_knn": 12, "sinkhorn": 1})):
                got = [c for k, c in train_events if k == kind]
                if len(got) != {"train": 12, "val": 6}[kind] or any(c != want for c in got):
                    fail(f"workflow: {kind} launches {got}, expected {want} each")
            timings = first.epoch_timings + second.epoch_timings
            vals = first.val_timings + second.val_timings
            cfg = second.cfg
            for t, v in zip(timings, vals):
                rates = ", ".join(f"{r:.3f}" for r in t["window_steps_per_s"])
                print(f"workflow epoch {t['epoch']}: {t['steps']} steps in {t['seconds']:.3f} s "
                      f"({t['seconds'] / t['steps'] * 1e3:.3f} ms/step), windowed steps/s "
                      f"[{rates}] ({', '.join(f'{1e3 / r:.3f}' for r in t['window_steps_per_s'])}"
                      f" ms/step; phase 6 isolated step {isolated_step_ms:.3f} ms); waited on the "
                      f"loader {t['loader_wait_s']:.3f} s ({100 * t['loader_wait_s'] / t['seconds']:.2f}"
                      f"% of the epoch); validation {v['pairs']:.0f} pairs in {v['seconds']:.3f} s "
                      f"({v['seconds'] / v['pairs'] * 1e3:.3f} ms/pair)")
            print(f"workflow train: trainval.main {train1_s:.3f} s (2 epochs), resumed "
                  f"{train2_s:.3f} s (1 epoch); resumed state equal to the snapshot; launches per "
                  f"train step {train_events[0][1]}, per val pair "
                  f"{next(c for k, c in train_events if k == 'val')}; best snapshot epoch "
                  f"{best['epoch']} score {best['score']}")

            # ---- snapshot save and restore on their own
            mgr = CheckpointManager(os.path.join(tmp, "timing"))
            sync()
            t0 = time.perf_counter()
            mgr.save(1, second.state, metadata={"epoch": 1})
            host_s = time.perf_counter() - t0
            mgr.wait_until_finished()
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(os.path.join(mgr.directory, "1", "state.pt"))
            fresh = create_train_state(cfg, RDMNet(cfg, device=dev))
            sync()
            t0 = time.perf_counter()
            mgr.restore(fresh)
            sync()
            restore_s = time.perf_counter() - t0
            equal_states(state_to_host(fresh), state_to_host(second.state), "restore timing")
            print(f"workflow snapshot: save {save_s * 1e3:.3f} ms ({host_s * 1e3:.3f} ms copying "
                  f"to the host, the rest writing), restore {restore_s * 1e3:.3f} ms, "
                  f"{nbytes / 1e6:.3f} MB on disk ({card})")
            del fresh, first

            # ---- what the loader's thread costs the loop: the CLI's prefetch of 2
            # against batches read on the loop's own thread, in turns, one
            # epoch each on the same data (seeds as trainval's)
            t = cfg.train
            for turn, prefetch in enumerate((0, 2, 2, 0)):
                ds = RegistrationPairDataset("kitti", root, "train", point_limit=t.point_limit,
                                             use_augmentation=t.use_augmentation, seed=cfg.seed)
                loader = PairLoader(ds, cap=cfg.pyramid.caps[0], shuffle=True, drop_last=True,
                                    seed=cfg.seed, prefetch=prefetch)
                probe = trainer_mod.Trainer(cfg, loader, output_dir=os.path.join(tmp, f"pf{turn}"),
                                            log_steps=1, device=dev)
                probe.train_epoch()
                e = probe.epoch_timings[-1]
                print(f"workflow loader prefetch {prefetch} (turn {turn}): ms per step "
                      f"{[round(1e3 / r, 3) for r in e['window_steps_per_s']]}, epoch "
                      f"{e['seconds'] * 1e3:.3f} ms ({e['seconds'] / e['steps'] * 1e3:.3f} "
                      f"ms/step), waited on the loader {e['loader_wait_s'] * 1e3:.3f} ms ({card})")
                del probe
            # the same batches through the train step outside the loop, each
            # step synchronised: what the data costs beside phase 6's one pair
            loader = PairLoader(RegistrationPairDataset(
                "kitti", root, "train", point_limit=t.point_limit,
                use_augmentation=t.use_augmentation, seed=cfg.seed),
                cap=cfg.pyramid.caps[0], shuffle=True, drop_last=True, seed=cfg.seed, prefetch=0)
            loader.peek()  # as the Trainer does
            batches = list(loader)
            state = create_train_state(cfg, RDMNet(cfg, device=dev, generator=torch.Generator()
                                                   .manual_seed(cfg.seed)),
                                       steps_per_epoch=len(batches))
            step, gen, alone_ms = orig[0](cfg, dev), torch.Generator(device=dev), []
            gen.manual_seed(cfg.seed + 1)
            for _ in range(2):
                for b in batches:
                    sync()
                    t0 = time.perf_counter()
                    state, _ = step(state, trainer_mod.batch_to_device(b, cfg.pyramid, dev), gen)
                    sync()
                    alone_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            print(f"workflow: the epoch's batches through the train step outside the loop, twice, "
                  f"each step synchronised: ms {alone_ms} ({card})")
            del state

            # ---- test the best snapshot
            feature_dir = os.path.join(tmp, "features")
            events.clear()
            reset_launch_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                board = test_cli.main(["--root", root, "--snapshot_dir",
                                       os.path.join(run, "snapshots_best"), "--buckets",
                                       "0.7,1.0", "--subset", "test", "--feature_dir",
                                       feature_dir, *cli_args])
            test_s = time.perf_counter() - t0
            print("\n".join("  " + line for line in out.getvalue().splitlines()))
            test_events = _per_event(events)
            if [c for _, c in test_events] != [{"radius_knn": 12, "sinkhorn": 1}] * 2:
                fail(f"workflow: test launches {test_events}")
            names = sorted(n for n in os.listdir(feature_dir) if n.endswith(".npz"))
            if len(names) != 2:
                fail(f"workflow: test wrote {names}")
            # each dump against the same pair through make_forward at its bucket
            cfgs = sorted(test_cfgs, key=lambda c: c.pyramid.caps[0])
            t0 = time.perf_counter()
            model = build_model_and_params(cfgs[-1], os.path.join(run, "snapshots_best"),
                                           device=dev)
            load_s = time.perf_counter() - t0
            dataset = RegistrationPairDataset("kitti", root, "test")
            write_ms, check_ms = [], []
            for i in range(len(dataset)):
                item = dataset[i]
                name = f"{item['seq_id']}_{item['src_frame']}_{item['ref_frame']}.npz"
                bi = choose_bucket(max(len(item["ref_points"]), len(item["src_points"])),
                                   [c.pyramid.caps[0] for c in cfgs])
                sync()
                t0 = time.perf_counter()
                want = trim_outputs(make_forward(cfgs[bi], model, with_gt=True, device=dev)(
                    *pad_pair_np(cfgs[bi], item["ref_points"], item["src_points"]),
                    item["transform"]), item["transform"])
                check_ms.append((time.perf_counter() - t0) * 1e3)
                got = dict(np.load(os.path.join(feature_dir, name)))
                if set(got) != set(want) or any(not np.array_equal(got[k], want[k]) for k in want):
                    bad = [k for k in want if k not in got or not np.array_equal(got[k], want[k])]
                    fail(f"workflow: {name} differs from make_forward + trim_outputs in {bad}")
                t0 = time.perf_counter()
                np.savez_compressed(os.path.join(tmp, "write_" + name), **got)
                write_ms.append((time.perf_counter() - t0) * 1e3)
            lines = [line for line in out.getvalue().splitlines() if "prep" in line]
            prep = [float(x) * 1e3 for x in re.findall(r"prep ([0-9.]+)s", "\n".join(lines))]
            proc = [float(x) * 1e3 for x in re.findall(r"proc ([0-9.]+)s", "\n".join(lines))]
            print(f"workflow test: {len(names)} dumps equal to make_forward + trim_outputs at "
                  f"their buckets; per pair prep {prep} ms, proc {proc} ms, the .npz write alone "
                  f"{[round(w, 3) for w in write_ms]} ms, forward + trim in sequence "
                  f"{[round(c, 3) for c in check_ms]} ms; run_eval_loop {loop_s[0] * 1e3 / len(names):.3f} "
                  f"ms/pair wall (in sequence, forward + trim + write: "
                  f"{(sum(check_ms) + sum(write_ms)) / len(names):.3f}); test.main {test_s:.3f} s in "
                  f"all (model build and snapshot load alone {load_s * 1e3:.3f} ms); launches per "
                  f"pair {test_events[0][1]} ({card})")
            print(f"workflow test board (a model trained for 12 steps: a plumbing check, not "
                  f"accuracy): {board.format()}")

            # ---- eval the dumps
            for method in ("lgr", "svd", "ransac"):
                json_out = os.path.join(tmp, f"eval_{method}.json")
                with contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    summary = eval_cli.main(["--feature_dir", feature_dir, "--method", method,
                                             "--json_out", json_out, "--device", dev.type])
                    eval_s = time.perf_counter() - t0
                with open(json_out) as f:
                    written = json.load(f)
                numbers = [v for k, v in written.items() if k not in ("method", "failed_pairs",
                                                                       "per_pair")]
                numbers += [v for p in written["per_pair"] for k, v in p.items()
                            if k not in ("seq_id", "src_frame", "ref_frame")]
                if set(written) != EVAL_JSON_KEYS or written["n_pairs"] != 2 or written != summary \
                        or not all(v is None or np.isfinite(v) for v in numbers):
                    fail(f"workflow: eval {method} wrote {written}")
                print(f"workflow eval {method}: {eval_s / written['n_pairs'] * 1e3:.3f} ms/pair; "
                      f"RR {written['RR']}, RRE {written['RRE_deg']} deg, RTE {written['RTE_m']} m, "
                      f"PIR {written['PIR']:.4f}, IR {written['IR']:.4f} (a model trained for 12 "
                      f"steps: a plumbing check, not accuracy; {card})")
    finally:
        (trainer_mod.make_train_step, trainer_mod.make_eval_step, trainer_mod.Trainer.resume,
         test_cli._make_eval_forward, test_cli.run_eval_loop) = orig
    counts = {}
    for key, kind, events_of in (("launches_per_trainer_step", "train", train_events),
                                 ("launches_per_val_pair", "val", train_events),
                                 ("launches_per_test_pair", "test", test_events)):
        got = [c for k, c in events_of if k == kind]
        counts[key] = {name: sum(c[name] for c in got) / len(got) for name in got[0]}
    return counts


FAMILY_STEPS = 3                         # train steps per family in phase 11
FAMILY_SEEDS = (1, 2)                    # weight draws of phase 11's card-vs-CPU check
PARITY_WARM, PARITY_TIMED, PARITY_STAGE = 2, 6, 3  # parity pairs of phase 11


def family_cfgs(base):
    """Phase 11's model families over ``base``: the other coarse transformers,
    ThDRoFormer with a sparse top-k schedule on every stage-2 layer, and the
    model without the vote layer."""
    r = dataclasses.replace
    return {
        "geotransformer": r(base, model=r(base.model, coarse_module="geotransformer")),
        "ape": r(base, model=r(base.model, coarse_module="ape")),
        "thdroformer_k2": r(base, thdroformer=r(base.thdroformer,
                                                k2=(0.5,) * base.thdroformer.num_layers2)),
        "vote_off": r(base, vote=r(base.vote, model_use_vote=False)),
    }


def upstream_key(key: str) -> str:
    """A port ``state_dict`` key -> an upstream RDMNet key that
    ``utils/torch_convert`` maps back to it (its rules inverted, with
    upstream's nesting)."""
    parts = key.split(".")
    if parts[0] in ("transformer", "transformer2") and re.fullmatch(r"(self|cross)_\d+", parts[1]):
        kind, idx = parts[1].rsplit("_", 1)
        rest = parts[2:]
        if rest[0] in ("attention", "linear", "norm"):
            rest = ["attention"] + rest
        return ".".join([parts[0], "transformer", "layers",
                         str(2 * int(idx) + (kind == "cross"))] + rest)
    if parts[0] in ("encoder", "decoder") and parts[-2] in ("norm", "norm_conv"):
        return ".".join(parts[:-1] + ["norm", parts[-1]])
    if parts[0] == "vote":
        m = re.fullmatch(r"(mlp|mlp_norm)_(\d+)", parts[1])
        if m:
            return ".".join(["vote", "mlp_modules", str(3 * int(m[2]) + (m[1] == "mlp_norm"))]
                            + parts[2:])
        if parts[1] == "out_norm":
            return ".".join(["vote", "out_proj", "1"] + parts[2:])
    return key


def rotate_kernel_points(model, seed):
    """A random rotation of every KPConv layer's kernel disposition, one per
    layer, as upstream draws them (the parity config reads each layer's own)."""
    import torch

    from rdmnet_tpu_torch.nn.kpconv import KPConv

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, KPConv):
                q, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen, dtype=torch.float64))
                q = q * torch.sign(torch.linalg.det(q))
                kp = mod.kernel_points
                kp.copy_((kp.double().cpu() @ q).to(kp))


def timed_pipeline(model, args, dev, warm, timed, n_stage, label):
    """``warm`` + ``timed`` + ``n_stage`` pipeline calls on ``args`` (the
    padded pair on the card); 12 kNN and 1 Sinkhorn launches per call or
    fail. Returns (ms/pair, peak bytes, per-stage ms, the last outputs)."""
    import torch

    from rdmnet_tpu_torch.models import pipeline
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    for _ in range(warm):
        out = pipeline(model, *args, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        out = pipeline(model, *args, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    peak = torch.cuda.max_memory_allocated()
    stage_ms = {}
    for _ in range(n_stage):
        marks = []

        def hook(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        prev = time.perf_counter()
        out = pipeline(model, *args, device=dev, stage_hook=hook)
        for name, t in marks:
            stage_ms[name] = stage_ms.get(name, 0.0) + (t - prev) * 1e3 / n_stage
            prev = t
    n = warm + timed + n_stage
    counts = launch_counts()
    if counts != {"radius_knn": 12 * n, "sinkhorn": n}:
        fail(f"{label}: launches {counts} over {n} pairs, expected 12 kNN and 1 Sinkhorn each")
    tf = out["estimated_transform"]
    if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
        fail(f"{label}: non-finite or misshapen estimated_transform")
    stages = (" stages " + json.dumps({k: round(v, 3) for k, v in stage_ms.items()})
              if n_stage else "")
    print(f"{label}: {ms:.3f} ms/pair over {timed} pairs, peak memory {peak / 2**20:.1f} MiB, "
          f"launches {counts} over {n} pairs (12 kNN and 1 Sinkhorn per pair){stages}")
    return ms, peak, stage_ms, out


def aligned_plan_error(a, b):
    """Max abs difference of two runs' log transport plans, patch by patch
    through their matched (ref, src) node pairs (near-equal matching scores
    may come out in another order); fails if the matched pairs differ."""
    import torch

    m = b["src_node_masks"].shape[0]
    keys = [(o["ref_node_corr_indices"].long().cpu() * m + o["src_node_corr_indices"].long().cpu())
            for o in (a, b)]
    order = torch.argsort(keys[0], stable=True)[torch.argsort(torch.argsort(keys[1], stable=True))]
    if not torch.equal(keys[0][order], keys[1]):
        return None, 0
    pa, pb = a["matching_scores"].cpu()[order], b["matching_scores"].cpu()
    live = pb > -1e11
    if not torch.equal(pa > -1e11, live):
        return None, 0
    return float((pa - pb)[live].abs().max()), int((order != torch.arange(len(order))).sum())


def model_surface_phase(dev, kernels, ref, src, gt):
    """Phase 11: the parity config, the other model families and the
    converter on the card, at ``make_cfg()`` width and the 0.7 bucket, on the
    phase-4 pair. Returns the launches per parity pair by kernel."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.cli.common import build_model_and_params
    from rdmnet_tpu_torch.config import make_cfg, make_parity_cfg, make_tiny_cfg
    from rdmnet_tpu_torch.data.procedural import procedural_pair
    from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_train_step
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud, search_plan
    from rdmnet_tpu_torch.models import RDMNet, pipeline
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.radius_knn import knn_plan
    from rdmnet_tpu_torch.utils.convert import params_from_jax, params_to_jax
    from rdmnet_tpu_torch.utils.torch_convert import export_state_dict, port_key_and_kind

    # ---- the parity config: 9 searches at K 63-81 ---------------------------
    pcfg = make_parity_cfg()
    pcfg = dataclasses.replace(pcfg, pyramid=pcfg.pyramid.scaled(0.7))
    cap = pcfg.pyramid.caps[0]
    args = (*pad_cloud(ref, cap, device=dev), *pad_cloud(src, cap, device=dev))
    model = RDMNet(pcfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    rotate_kernel_points(model, SEED)
    batch = build_pair_batch(*args, torch.eye(4, device=dev), pcfg.pyramid)
    pts, cnts = pair_levels(batch, pcfg.pyramid.num_stages)
    ks = [item.k for item in search_plan(pcfg.pyramid)]
    knn_ms, knn_call_ms, knn_plain_ms, knn_bound = check_searches(pts, cnts, pcfg.pyramid,
                                                                  kernels, prefix="parity ")
    print(f"parity radius_knn per pair (12 searches, K {ks}): kernel {knn_ms:.4f} ms on the "
          f"device, {knn_call_ms:.4f} ms in wrapper calls; plain {knn_plain_ms:.3f} ms, bound "
          f"{knn_bound:.5f} ms; tables equal to the plain version's")
    kernels["radius_knn"].update(parity_ms=knn_ms, parity_bound_ms=knn_bound)
    ms, peak, stage_ms, out = timed_pipeline(model, args, dev, PARITY_WARM, PARITY_TIMED,
                                             PARITY_STAGE, "parity pipeline (make_parity_cfg, "
                                             "0.7 bucket, per-layer kernel points)")
    per_pair = {"radius_knn": 12, "sinkhorn": 1}

    # ---- the 256-entry list at level-0 shapes ----------------------------------
    level0 = search_plan(pcfg.pyramid)[0]
    for k in (81, 256):
        sp = level0._replace(k=k)
        ms_k, call_k, pms_k, bound_k, pairs, plan = check_knn(pts, cnts, sp, kernels)
        print(knn_line(f"level-0 K={k} band={sp.band}", ms_k, call_k, pms_k, bound_k, plan, None)
              + f"; candidate pairs {pairs}; table equal to the plain version's")
        if plan.k_bucket != (128 if k <= 128 else 256):
            fail(f"radius_knn K={k}: list bucket {plan.k_bucket}")
        kernels["radius_knn"][f"level0_k{k}_ms"] = ms_k

    # ---- converter on the card ---------------------------------------------------
    state = model.state_dict()
    schema = {upstream_key(k): tuple(v.shape) for k, v in state.items()}
    if any(port_key_and_kind(up)[0] != k for up, k in zip(schema, state)):
        fail("converter: the upstream schema does not map back onto the model")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rdmnet.pth.tar")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              export_state_dict(state, schema).items()}, "epoch": 0}, path)
        converted = build_model_and_params(pcfg, device=dev, torch_checkpoint=path)
    carried = RDMNet(pcfg, device=dev, generator=torch.Generator().manual_seed(SEED + 1))
    carried.load_state_dict(params_from_jax(params_to_jax(model)), strict=True)
    tf_a = pipeline(converted, *args, device=dev)["estimated_transform"]
    tf_b = pipeline(carried, *args, device=dev)["estimated_transform"]
    diff = float((tf_a - tf_b).abs().max())
    print(f"converter on the card: {len(schema)} upstream tensors through a .pth.tar, loaded "
          f"strict; pose against the same weights through params_from_jax: max abs diff {diff:.3e}")
    if diff > 1e-6 or not bool(torch.isfinite(tf_a).all()):
        fail(f"converter: the converted checkpoint's pose differs by {diff}")
    del model, converted, carried, batch
    torch.cuda.empty_cache()

    # ---- the other families at full width --------------------------------------
    base = dataclasses.replace(make_cfg(), pyramid=make_cfg().pyramid.scaled(0.7))
    host = host_pair(ref, src, gt, cap)
    tiny = make_tiny_cfg()
    small, _, _ = procedural_pair(SEED + 2, n_rings=16, n_azimuths=200)
    small = small[np.random.RandomState(0).permutation(len(small))[:500]]
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    moved = ((small - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)
    tcap = tiny.pyramid.caps[0]
    for (name, cfg), (_, tcfg) in zip(family_cfgs(base).items(), family_cfgs(tiny).items()):
        model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        timed_pipeline(model, args, dev, 1, 3, 0, f"{name} pipeline (0.7 bucket)")
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(FAMILY_STEPS):
            reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch_to_device(host, cfg.pyramid, device=dev), gen)
            metrics = {k: float(v) for k, v in metrics.items()}
            step_ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            if counts != {"radius_knn": 12, "sinkhorn": 0}:
                fail(f"{name} train step {i}: launches {counts}, expected 12 kNN and 0 Sinkhorn")
            if not all(np.isfinite(v) for v in metrics.values()) or metrics["grad_norm"] <= 0:
                fail(f"{name} train step {i}: non-finite losses or gradient: {metrics}")
            print(f"{name} train step {i}: {step_ms:.3f} ms, "
                  + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()))
        print(f"{name} training: peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"over {FAMILY_STEPS} steps, 12 kNN and 0 Sinkhorn launches per step")
        del model, state, step
        torch.cuda.empty_cache()

        for seed in FAMILY_SEEDS:
            outs = []
            for d in (dev, torch.device("cpu")):
                m = RDMNet(tcfg, device=d, generator=torch.Generator().manual_seed(seed))
                outs.append(pipeline(m, *pad_cloud(small, tcap, device=d),
                                     *pad_cloud(moved, tcap, device=d), device=d))
            o_gpu, o_cpu = outs
            for side in ("ref", "src"):
                g, c = getattr(o_gpu["batch"], side), getattr(o_cpu["batch"], side)
                for field in ("points", "neighbors", "subsampling", "upsampling"):
                    for lvl, (a, b) in enumerate(zip(getattr(g, field), getattr(c, field))):
                        if not torch.equal(a.cpu(), b):
                            fail(f"{name} card vs CPU (weights {seed}): {side} {field}[{lvl}]")
            for key in ("nodes_ref_valid", "nodes_src_valid", "node_corr_valid"):
                if not torch.equal(o_gpu[key].cpu(), o_cpu[key]):
                    fail(f"{name} card vs CPU (weights {seed}): {key} differ")
            err, swapped = aligned_plan_error(o_gpu, o_cpu)
            if err is None or err > 1e-3:
                fail(f"{name} card vs CPU (weights {seed}): matched patches or plans differ ({err})")
            pose = float((o_gpu["estimated_transform"].cpu() - o_cpu["estimated_transform"])
                         .abs().max())
            print(f"{name} card vs CPU (tiny cfg, weights {seed}): tables and node masks equal, "
                  f"matched node pairs equal ({swapped} patches in another order), plans within "
                  f"{err:.3e}; pose {pose:.3e}")
    return per_pair


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA card")
    import numpy as np

    from rdmnet_tpu_torch.config import make_cfg, make_tiny_cfg
    from rdmnet_tpu_torch.data.loader import choose_bucket
    from rdmnet_tpu_torch.data.procedural import procedural_pair, procedural_sequence
    from rdmnet_tpu_torch.device import set_precision
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud, search_plan
    from rdmnet_tpu_torch.models import RDMNet, pipeline
    from rdmnet_tpu_torch.models.rdmnet import STAGES
    from rdmnet_tpu_torch.ops.kernels import _build, launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda, sinkhorn_plain
    from rdmnet_tpu_torch.ops.lgr import local_to_global_registration

    card = smi("name,power.limit")
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda")
    set_precision()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} "
          f"({card}), max SM clock {max_clock_mhz:.0f} MHz")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    builds = [_build.Build(name) for name in _build.KERNELS]
    for b in builds:
        for line in b.wait().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "built")):
                print(f"[{b.name}] {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spills and (int(spills[1]) or int(spills[2])):
                fail(f"build: {b.name} spills registers: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(builds)} kernels")

    kernels = {
        "radius_knn": dict(name="radius_knn", route="cuda",
                           source="rdmnet_tpu_torch/csrc/radius_knn.cu",
                           replaces="rdmnet_tpu/ops/pallas/radius_knn.py:93",
                           launches=0, max_abs_err=0.0, library_ms=None, design=DESIGN),
        "sinkhorn": dict(name="sinkhorn", route="cuda",
                         source="rdmnet_tpu_torch/csrc/sinkhorn.cu",
                         replaces="rdmnet_tpu/ops/pallas/sinkhorn.py:59",
                         launches=0, max_abs_err=0.0, library_ms=None, design=DESIGN),
    }

    # ---- main-path input and model ------------------------------------------
    ref, src, gt = procedural_pair(SEED, n_rings=80, n_azimuths=3000)
    cfg = make_cfg()
    buckets = [cfg.pyramid.scaled(0.7), cfg.pyramid]
    bi = choose_bucket(max(len(ref), len(src)), [b.caps[0] for b in buckets])
    cfg = dataclasses.replace(cfg, pyramid=buckets[bi])
    cap = cfg.pyramid.caps[0]
    print(f"input: ref {len(ref)} / src {len(src)} points, bucket caps {cfg.pyramid.caps}, "
          f"band caps {cfg.pyramid.band_caps}")
    model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    rp, rc = pad_cloud(ref, cap, device=dev)
    sp, sc = pad_cloud(src, cap, device=dev)

    # ---- 3. kernels vs plain at main-path shapes -------------------------
    batch = build_pair_batch(rp, rc, sp, sc, torch.eye(4, device=dev), cfg.pyramid)
    pts, cnts = pair_levels(batch, cfg.pyramid.num_stages)
    knn_ms, knn_call_ms, knn_plain_ms, knn_bound = check_searches(pts, cnts, cfg.pyramid,
                                                                  kernels, v1=V1_KNN_MS)
    level0 = search_plan(cfg.pyramid)[0]
    for extra in (level0._replace(band=None),
                  level0._replace(band=None, k=1, radius=2 * cfg.pyramid.search_radius)):
        ms, call_ms, pms, bound, _, plan = check_knn(pts, cnts, extra, kernels)
        print(knn_line(f"level-0 unbanded K={extra.k} r={extra.radius}", ms, call_ms, pms, bound,
                       plan, V1_KNN_MS.get(("unbanded", 0, 0, extra.k))))
    # every level-0 point twice (rows 2i-1 and 2i): each query's nearest two
    # are at one distance, so the table shows the (distance, index) tie order
    twin = (torch.arange(cap, device=dev) + 1) // 2
    dup_pts = [p[:, twin].contiguous() for p in pts[:1]] + pts[1:]
    dup_cnts = [torch.clamp(2 * cnts[0] - 1, max=cap)] + cnts[1:]
    ms, call_ms, pms, bound, _, plan = check_knn(dup_pts, dup_cnts, level0, kernels)
    print(knn_line(f"level-0 duplicated points K={level0.k} band={level0.band}", ms, call_ms,
                   pms, bound, plan, None) + ": table equal to the plain version's")
    v1 = sum(V1_KNN_MS[(i.table, i.q_lvl, i.s_lvl, i.k)] for i in search_plan(cfg.pyramid))
    print(f"radius_knn per pair (12 searches): kernel {knn_ms:.4f} ms on the device, "
          f"{knn_call_ms:.4f} ms in wrapper calls, v1 design {v1:.4f} ms in wrapper calls; "
          f"plain {knn_plain_ms:.3f} ms, bound {knn_bound:.5f} ms, tables equal to the plain "
          f"version's (max abs index difference {kernels['radius_knn']['max_abs_err']})")

    rng = np.random.RandomState(SEED)
    p, k1, iters = 256, 129, 100
    scores = (rng.randn(p, k1, k1) * 3).astype(np.float32)
    log_mu = np.full((p, k1), -np.log(2 * (k1 - 1)), np.float32)
    log_nu = log_mu.copy()
    masked_patch = rng.rand(p) < 0.1
    scores[masked_patch] = -1e12
    log_mu[masked_patch, :-1] = -1e12
    log_nu[masked_patch, :-1] = -1e12
    rows = (rng.rand(p, k1) < 0.1) & ~masked_patch[:, None]
    rows[:, -1] = False
    scores[rows] = -1e12
    log_mu[rows] = -1e12
    s_t, mu_t, nu_t = (torch.from_numpy(x).to(dev) for x in (scores, log_mu, log_nu))
    got = sinkhorn_cuda(s_t, mu_t, nu_t, iters)
    torch.cuda.synchronize()
    want = sinkhorn_plain(s_t, mu_t, nu_t, iters)
    live = want > -1e11
    if not torch.isfinite(got).all() or not torch.equal(got > -1e11, live):
        fail("sinkhorn: non-finite output or masked entries differ")
    err = float((got - want)[live].abs().max())
    kernels["sinkhorn"]["max_abs_err"] = err
    if err > 1e-4:
        fail(f"sinkhorn: max abs error {err} > 1e-4")
    s_ms = graph_ms(lambda: sinkhorn_cuda(s_t, mu_t, nu_t, iters), reps=20)
    s_call_ms = cuda_ms(lambda: sinkhorn_cuda(s_t, mu_t, nu_t, iters), reps=20)
    s_plain = cuda_ms(lambda: sinkhorn_plain(s_t, mu_t, nu_t, iters), reps=3)
    entries = p * k1 * k1
    exp_s = 2 * iters * entries / (NUM_SMS * SFU_PER_SM_CLK * max_clock_mhz * 1e6)
    ops_s = 2 * iters * entries * SINKHORN_OPS_PER_ENTRY / F32_FLOPS
    bytes_s = (2 * entries + 2 * p * k1) * 4 / HBM_BYTES_PER_S
    s_bound = max(exp_s, ops_s, bytes_s) * 1e3
    print(f"sinkhorn P={p} K1={k1} iters={iters}: kernel {s_ms:.4f} ms on the device, "
          f"{s_call_ms:.4f} ms per call, v1 design {V1_SINKHORN_MS:.4f} ms per call; plain "
          f"{s_plain:.3f} ms, bound {s_bound:.5f} ms (exp {exp_s * 1e3:.5f}, f32 ops "
          f"{ops_s * 1e3:.5f}, bytes {bytes_s * 1e3:.5f}), max abs err {err:.3e}")
    kernels["radius_knn"].update(ms=knn_ms, ms_per_call=knn_call_ms, plain_ms=knn_plain_ms,
                                 bound_ms=knn_bound, bound_by="operations")
    kernels["sinkhorn"].update(ms=s_ms, ms_per_call=s_call_ms, plain_ms=s_plain, bound_ms=s_bound,
                               bound_by="operations" if max(exp_s, ops_s) >= bytes_s else "bytes")

    # ---- 4. main path -----------------------------------------------------
    n_warm, n_timed, n_stage = 3, 12, 5
    jitter = [rp + 1e-6 * (i + 1) for i in range(n_warm + n_timed)]
    reset_launch_counts()
    for i in range(n_warm):
        out = pipeline(model, jitter[i], rc, sp, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [pipeline(model, jitter[n_warm + i], rc, sp, sc, device=dev)["estimated_transform"]
            for i in range(n_timed)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    peak = torch.cuda.max_memory_allocated()
    stage_ms = {name: 0.0 for name in STAGES}
    for _ in range(n_stage):
        marks = []

        def hook(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        start = time.perf_counter()
        out = pipeline(model, rp, rc, sp, sc, device=dev, stage_hook=hook)
        prev = start
        for name, t in marks:
            stage_ms[name] += (t - prev) * 1e3 / n_stage
            prev = t
    counts = launch_counts()
    n_pairs = n_warm + n_timed + n_stage
    for name, n in counts.items():
        kernels[name]["launches"] = n
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")
    tf = out["estimated_transform"]
    if not all(bool(torch.isfinite(t).all()) for t in outs + [tf]) or tf.shape != (4, 4):
        fail("main path: non-finite or misshapen estimated_transform")
    rot_err = float(np.degrees(np.arccos(np.clip(
        (np.trace(tf[:3, :3].cpu().numpy().T @ gt[:3, :3]) - 1) / 2, -1, 1))))
    print("main path stages (ms, mean of %d pairs, synchronised at each stage): %s" % (
        n_stage, json.dumps({k: round(v, 3) for k, v in stage_ms.items()})))
    print(f"main path: {dt * 1e3:.3f} ms/pair, {1.0 / dt:.4f} pairs/s over {n_timed} pairs, "
          f"peak memory {peak / 2**20:.1f} MiB, dropped {out['dropped'].tolist()}, "
          f"NMS rounds {out['nms_rounds']}, launches {counts} over {n_pairs} pairs "
          f"({ {k: v / n_pairs for k, v in counts.items()} } per pair), "
          f"rotation vs ground truth {rot_err:.2f} deg (random weights)")

    # ---- 5. card vs CPU on the whole path at a small config ---------------
    # A scan against a rigidly moved copy through both devices, with the same
    # weights, for each draw of WEIGHT_SEEDS. Held for every draw: every
    # index table equal and the log transport plans within 1e-3; then LGR on
    # the CPU's patches and plans, run on both devices: the same
    # correspondence set and per-patch Procrustes hypotheses whose weighted
    # residuals agree within 1e-4 m (a residual stays well-posed where a
    # patch's few correspondences leave its pose ill-conditioned). The poses
    # are held to 1e-4 only for draws whose CPU pose registers the pair:
    # random weights otherwise pick a hypothesis that rests on a few
    # ill-conditioned correspondences, and the pose is chaotic in the last
    # bits of the plans. The draw of WEIGHT_SEEDS[0] registers it.
    tiny = make_tiny_cfg()
    small, _, _ = procedural_pair(SEED + 2, n_rings=16, n_azimuths=200)
    small = small[np.random.RandomState(0).permutation(len(small))[:500]]
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    moved = ((small - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)
    tcap = tiny.pyramid.caps[0]
    registered, diverged = [], []
    for seed in WEIGHT_SEEDS:
        m_gpu = RDMNet(tiny, device=dev, generator=torch.Generator().manual_seed(seed))
        m_cpu = RDMNet(tiny, device="cpu", generator=torch.Generator().manual_seed(seed))
        o_gpu = pipeline(m_gpu, *pad_cloud(small, tcap, device=dev),
                         *pad_cloud(moved, tcap, device=dev), device=dev)
        o_cpu = pipeline(m_cpu, *pad_cloud(small, tcap), *pad_cloud(moved, tcap), device="cpu")
        for side in ("ref", "src"):
            g, c = getattr(o_gpu["batch"], side), getattr(o_cpu["batch"], side)
            for field in ("points", "neighbors", "subsampling", "upsampling"):
                for lvl, (a, b) in enumerate(zip(getattr(g, field), getattr(c, field))):
                    if not torch.equal(a.cpu(), b):
                        fail(f"card vs CPU (weights {seed}): {side} {field}[{lvl}] differ")
        for key in ("dropped", "nodes_ref_valid", "nodes_src_valid", "ref_node_corr_indices",
                    "src_node_corr_indices", "node_corr_valid"):
            if not torch.equal(o_gpu[key].cpu(), o_cpu[key]):
                fail(f"card vs CPU (weights {seed}): {key} differ")
        live = o_cpu["matching_scores"] > -1e11
        ms_err = float((o_gpu["matching_scores"].cpu() - o_cpu["matching_scores"])[live].abs().max())
        if ms_err > 1e-3:
            fail(f"card vs CPU (weights {seed}): matching scores differ by {ms_err} > 1e-3")

        lgr_in = [o_cpu[key] for key in LGR_INPUTS]
        corr_c, tf_c = local_to_global_registration(*lgr_in, tiny.fine_matching)
        corr_g, tf_g = local_to_global_registration(*[x.to(dev) for x in lgr_in],
                                                    tiny.fine_matching)
        if not (torch.equal(corr_g.ref_points.cpu(), corr_c.ref_points)
                and torch.equal(corr_g.src_points.cpu(), corr_c.src_points)):
            fail(f"card vs CPU (weights {seed}): LGR correspondence sets differ")
        sc_err = float((corr_g.scores.cpu() - corr_c.scores).abs().max())
        if sc_err > 1e-6:
            fail(f"card vs CPU (weights {seed}): correspondence scores differ by {sc_err} > 1e-6")
        (res_g, n_g), (res_c, n_c) = hypothesis_residuals(corr_g), hypothesis_residuals(corr_c)
        posed = n_c >= tiny.fine_matching.correspondence_threshold
        hyp_err = float((res_g.cpu() - res_c)[posed].abs().max()) if bool(posed.any()) else 0.0
        if hyp_err > 1e-4:
            fail(f"card vs CPU (weights {seed}): hypothesis residuals differ by {hyp_err} m")

        tf_err = float((o_gpu["estimated_transform"].cpu()
                        - o_cpu["estimated_transform"]).abs().max())
        lgr_err = float((tf_g.cpu() - tf_c).abs().max())
        reg_err = float(np.abs(o_cpu["estimated_transform"].numpy() - motion).max())
        print(f"card vs CPU (tiny cfg, weights {seed}): index tables equal, matching scores max "
              f"abs diff {ms_err:.3e}; LGR on the same plans: correspondence sets equal, scores "
              f"{sc_err:.3e}, {int(posed.sum())} hypotheses' residuals within {hyp_err:.3e} m, "
              f"pose {lgr_err:.3e}; whole-path pose {tf_err:.3e}; CPU pose vs known motion "
              f"{reg_err:.3e}")
        if reg_err <= 0.05:
            registered.append(seed)
            if max(tf_err, lgr_err) > 1e-4:
                fail(f"card vs CPU (weights {seed}): registered poses differ by "
                     f"{max(tf_err, lgr_err)} > 1e-4")
        elif max(tf_err, lgr_err) > 1e-4:
            diverged.append(seed)
    if WEIGHT_SEEDS[0] not in registered:
        fail(f"card vs CPU: the weights of seed {WEIGHT_SEEDS[0]} no longer register the pair")
    print(f"card vs CPU: {len(registered)} of {len(WEIGHT_SEEDS)} weight draws register the "
          f"pair (poses held to 1e-4: {registered}); of the others, {len(diverged)} have card "
          f"and CPU poses more than 1e-4 apart: {diverged}")

    # ---- 6. training path at full width ------------------------------------
    tr = train_phase(cfg, host_pair(ref, src, gt, cap), dev)
    for name, n in tr["train_counts"].items():
        kernels[name]["launches_per_train_step"] = n / (TRAIN_WARM + TRAIN_TIMED)
    for name, n in tr["eval_counts"].items():
        kernels[name]["launches_per_eval_step"] = n
    ms = sorted(tr["step_ms"])
    print("train step parts (ms, mean of %d steps, synchronised at each part): %s" % (
        TRAIN_TIMED, json.dumps({k: round(v, 3) for k, v in tr["parts"].items()})))
    print(f"train path: {sum(ms) / len(ms):.3f} ms/step (median {ms[len(ms) // 2]:.3f}, min "
          f"{ms[0]:.3f}, max {ms[-1]:.3f}) over {TRAIN_TIMED} steps, build included; peak memory "
          f"{tr['peak'] / 2**20:.1f} MiB; weights moved by up to {tr['moved']:.3e}; launches "
          f"{tr['train_counts']} over {TRAIN_WARM + TRAIN_TIMED} steps")
    print("eval step: " + ", ".join(f"{k} {v:.6g}" for k, v in tr["eval"].items())
          + f"; launches {tr['eval_counts']} (random weights after {TRAIN_WARM + TRAIN_TIMED} "
          "steps)")

    # ---- 7. card vs CPU on one train step at a small config ---------------
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    pick = np.random.RandomState(0)
    small_ref = scans[0][pick.permutation(len(scans[0]))[:500], :3]
    small_src = scans[1][pick.permutation(len(scans[1]))[:480], :3]
    train_card_vs_cpu(tiny, host_pair(small_ref, small_src, np.linalg.inv(poses[0]) @ poses[1],
                                      tcap), dev)

    # ---- 8. serving at full width ---------------------------------------------
    for name, n in serving_phase(dev, card, kernels).items():
        kernels[name]["launches_per_served_request"] = n

    # ---- 9. RANSAC on the card ------------------------------------------------
    ransac_phase(dev, card)

    # ---- 10. train -> snapshot -> test -> eval ---------------------------------
    step_ms = sum(tr["step_ms"]) / len(tr["step_ms"])
    for key, per in workflow_phase(dev, card, kernels, step_ms).items():
        for name, n in per.items():
            kernels[name][key] = n

    # ---- 11. the model surface: parity config, families, converter -------------
    for name, n in model_surface_phase(dev, kernels, ref, src, gt).items():
        kernels[name]["launches_per_parity_pair"] = n

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
