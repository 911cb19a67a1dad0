"""Kernel measurements beside ``chip_smoke.py``'s checks: which select path
the radius-kNN kernel should take at large k, where the time of its two
select paths and of the cluster and group Sinkhorn goes, the group path's
two merge designs side by side, and device times through the public
wrappers that another tree's kernels can be timed by in the same call.

    python -m rdmnet_tpu_torch.tools.kernel_probe
        [--parts routes,select_split,knn_split,sinkhorn_split,group_split,spill_split,times]
        [--out FILE.json]
    PYTHONPATH=OTHER_TREE python rdmnet_tpu_torch/tools/kernel_probe.py --parts times

Needs an NVIDIA card and ``nvcc``. The parts:

- ``routes``: the warp and the block select paths of ``csrc/radius_knn.cu``
  launched side by side (``select_plan`` and ``block_plan``, whichever
  ``knn_plan`` would pick), each table held equal to the plain version, on
  three kinds of window: (a) the level-0 search of procedural scans (64
  rings x 1800 azimuths, ``data.procedural``) downsampled at 0.3 to 0.05 m
  and calibrated as ``rdmnet-torch-preprocess calibrate`` does
  (``point_limit`` 30000, keep ratio 0.8), at the limit and band cap each
  calibration gives; (b) the level-0 search of ``chip_smoke.py``'s phase-4
  pair at limits 320 to 4096; (c) a dense synthetic band where every list
  fills (``chip_smoke.py`` phase 3's 8192-row band). Each window's bound
  beside (``knn_bound``: 9 float32 operations a pair of a valid query and a
  valid row in a 32-row chunk its radius reaches, or the bytes).
- ``select_split``: a copy of ``csrc/radius_knn.cu`` with ``clock64()``
  stamps in the warp select path (every warp's lane 0, summed): the
  chunk boxes, the count sweep, the radix passes, the collect sweep, the
  sort and the store, per query and as shares, with the share of queries
  whose in-radius rows overflow the sort buffer, their radix passes and the
  32-row chunks a query sweeps, on phase 16's two level-0 searches (k 320),
  the calibrated windows of (a) on that path and the dense band at k 320.
- ``knn_split``: the same for the block select path (thread 0 of every
  CTA, summed over CTAs), at k = 2048 on (b) and (c).
- ``sinkhorn_split``: a copy of ``csrc/sinkhorn.cu`` with stamps in the
  cluster path (CTA 0's thread 0, per iteration) at P = 256, K1 = 257 and
  513, 100 iterations.
- ``group_split``: the group path at P = 32, K1 = 600 and 1025, 100
  iterations: a copy with stamps (CTA 0's thread 0, per iteration: row
  step, column sweep, barrier, merge, v read), and a copy whose exchange is
  the other merge design, a redundant merge (every CTA merging all K1
  columns from the G partials, which sit in two parity buffers), timed
  beside the kernel's reduce-scatter and stamped too.
- ``spill_split``: the group path past K1 = 2640 at (P, K1) = (8, 2641)
  and (2, 4096), its row step and column sweep cut into the rows a CTA
  keeps in shared memory and those it reads from device memory.
- ``times``: device ms through ``radius_knn_cuda`` and ``sinkhorn_cuda``
  on the ``select_split`` windows and Sinkhorn's group cases of
  ``chip_smoke.py`` phase 3, each held against the plain version. It uses
  only what every version of the port has: run as a file with another
  tree's root first on ``PYTHONPATH``, it times that tree's kernels.

The copies are written to and built in ``rdmnet_tpu_torch/_build/``; the
kernels themselves carry no measurement code. Device times are CUDA-graph
replays of 5 calls (2 of the Sinkhorn calls in ``times`` and ``spill_split``)."""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 7351  # chip_smoke.py's seed: its phase-4 pair and phase-3 dense band
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12  # H100 SXM: device memory, float32 outside the MMA
KNN_OPS_PER_PAIR = 9  # 3 FMA (2 each), sub, add, max per (query, candidate)
REPS = 5
CAL_VOXELS = (0.3, 0.15, 0.1, 0.075, 0.05)  # (a): downsampling voxels, m
CAL_FRAMES, CAL_STEP = 4, 4.0                # (a): scans of one procedural sequence, m apart
CAL_SCAN = dict(n_rings=64, n_azimuths=1800, voxel_size=0.01)
PAIR_KS = (320, 512, 1024, 1536, 2048, 4096)  # (b), (c): level-0 limits
DENSE = dict(n=16000, box=(10.0, 3.0, 2.0), radius=2.0, band=8192, chunk=256, cell=0.6)

# (region start, region end, [(anchor, stamp part or None for the start, after?)])
KNN_STAMPS = ("radius_knn_block_kernel(const float*", 'extern "C" int radius_knn_block_launch', [
    ("  const unsigned lanes_below = (1u << lane) - 1u;\n", None, True),
    ("  const int n = n_sh;\n", 0, True),
    ("    block_sort(keys, n, whist, bits_sh, wsum_sh);\n", 2, False),
    ("    block_sort(keys, n, whist, bits_sh, wsum_sh);\n", 3, True),
    ("op[i] = (int)(unsigned)keys[i];\n", 4, True),
    ("      const unsigned long long hi_t = hi < n ? separator(hi) : ~0ull;\n", 1, True),
    ("      block_sort(sbuf, cnt_sh, whist, bits_sh, wsum_sh);\n", 2, False),
    ("      block_sort(sbuf, cnt_sh, whist, bits_sh, wsum_sh);\n", 3, True),
    ("      lo_t = hi_t;\n", 4, True),
    ("i += KNB_THREADS) op[i] = S;\n", "  __syncthreads();\n  PROBE_STAMP(5)\n", True),
])
KNN_PARTS = ("cache sweep", "separator", "gather", "sort", "write", "sentinels")
SKC_STAMPS = ("sinkhorn_cluster_kernel(const float*", "typedef void (*ClusterKernel)", [
    ("  for (int it = 0; it < iters; ++it) {\n", None, False),
    ("    __syncwarp();\n\n    // v: the warp's column partials", 0, "mid"),
    ("    __syncthreads();\n    float2* xq", 1, False),
    ("    float2* xq", 2, False),
    ("    cluster.sync();  // every CTA's partials of this iteration are visible\n", 3, False),
    ("    cluster.sync();  // every CTA's partials of this iteration are visible\n", 4, True),
    ("    __syncthreads();\n#pragma unroll\n    for (int j = 0; j < NC - 1; ++j) v[j]", 5, False),
    ("    v[NC - 1] = last_ok ? v_sh[32 * (NC - 1) + lane] : 0.f;\n", 6, True),
])
SKC_PARTS = ("row step", "column sweeps", "barrier 1", "local merge", "cluster barrier",
             "remote merge", "barrier 2")
GROUP_REGION = ("sinkhorn_group_kernel(const float*", "static int group_config(")
# the kernel's exchange (a reduce-scatter: CTA `rank` merges its slice of the
# columns and publishes it tagged, every CTA reads all of v) and what the
# redundant merge puts in its place: every CTA merges all K1 columns, with
# the partials in two parity buffers (one barrier an iteration orders a
# CTA's next partials only after its own merge, not after the others')
GROUP_EXCHANGE = """      group_barrier(counter, ++arrivals * G);
      merge_columns(part, log_nu + (size_t)p * K1, G, K1, S, c0, n_merge,
                    [vt, step](int c, float v) { store_tagged(vt + c, v, step + 1); });
      for (int c = tid; c < K1; c += SKG_THREADS) v_sh[c] = load_tagged(vt + c, step + 1);
      __syncthreads();
"""
GROUP_REDUNDANT = [
    (GROUP_EXCHANGE, """      group_barrier(counter, ++arrivals * G);
      merge_columns(part + (size_t)(step & 1) * G * K1, log_nu + (size_t)p * K1, G, K1, S, 0,
                    K1, [v_sh](int c, float v) { v_sh[c] = v; });
      __syncthreads();
"""),
    ("__stcg(part + (size_t)rank * K1 + c,", "__stcg(part + ((size_t)(step & 1) * G + rank) * K1 + c,"),
    ("scratch + (size_t)grp * 2 * ((size_t)G + 1) * K1)",
     "scratch + (size_t)grp * 2 * (2 * (size_t)G + 1) * K1)"),
]
GROUP_START = ("    for (int it = 0; it < iters; ++it, ++step) {\n", None, False)
GROUP_SWEEPS = [("      // v: the CTA's column partials over its band", 0, False),
                ("      // the exchange: CTA `rank` merges", 1, False),
                ("      group_barrier(counter, ++arrivals * G);\n      merge_columns(", 2, "mid")]
GROUP_STAMPS = (*GROUP_REGION, [
    GROUP_START, *GROUP_SWEEPS,
    ("[vt, step](int c, float v) { store_tagged(vt + c, v, step + 1); });\n", 3, True),
    ("v_sh[c] = load_tagged(vt + c, step + 1);\n      __syncthreads();\n", 4, True),
])
GROUP_PARTS = ("row step", "column sweep", "barrier", "merge", "v read")
REDUNDANT_STAMPS = (*GROUP_REGION, [
    GROUP_START, *GROUP_SWEEPS,
    ("K1, [v_sh](int c, float v) { v_sh[c] = v; });\n      __syncthreads();\n", 3, True),
])
REDUNDANT_PARTS = ("row step", "column sweep", "barrier", "merge")
SELECT_STAMPS = ("radius_knn_select_kernel(const float*", 'extern "C" int radius_knn_select_launch', [
    ("  if (!tiled && end > w) make_boxes(w, end - w);\n", None, False),
    ("  if (!tiled && end > w) make_boxes(w, end - w);\n", "  unsigned probe_chunks_ = 0;\n",
     False),
    ("  // One sweep over the window in index order", 0, False),
    ("            if (i[u] < 0) break;\n", "            ++probe_chunks_;\n", True),
    ("  // more candidates than the buffer holds", 1, False),
    ("    if (on) {\n      __syncwarp();\n      const int rr", "PROBE_ADD(10, 1)\n", "mid"),
    ("  if (tiled ? __syncthreads_or(pick) : pick) {\n", 2, False),
    ("  if (active) {\n    __syncwarp();\n    warp_sort(", 3, False),
    ("    warp_sort(buf, min(n_in, sort_rows), lane);\n", 4, True),
    ("    warp_sort(buf, min(n_in, sort_rows), lane);\n",
     "    PROBE_ADD(9, pick)\n    PROBE_ADD(11, probe_chunks_)\n", True),
    ("    for (int i = m_out + lane; i < K; i += 32) op[i] = S;\n", 5, True),
])
SELECT_PARTS = ("boxes", "count sweep", "radix passes", "collect sweep", "sort", "store")
# probe words counting, over the queries: those whose in-radius rows overflow
# the sort buffer, their radix passes, and the 32-row chunks swept
SELECT_OVERFLOW, SELECT_PASSES, SELECT_CHUNKS = 9, 10, 11
SELECT_PAIR_K = 320  # phase 16's level-0 limit
GROUP_K1S = (600, 1025)
GROUP_P = 32
# past K1 = 2640, where bands spill: a CTA-wide barrier after the shared rows'
# row step (the copy's only), and thread 0's column sweep cut after each
# segment, so the shared and the spilled rows' times come apart
SPILL_STAMPS = (*GROUP_REGION, [
    GROUP_START,
    ("        for (; r < nb; r += SKG_WARPS) group_row_lse<1>(spill", "        __syncthreads();\n"
     "        PROBE_STAMP(0)\n", False),
    ("      // v: the CTA's column partials over its band", 1, False),
    ("        col_fold_rows<SPILL ? 4 : SKG_RR>(band, 0, ns, c, u_sh, ma, sa, mb, sb);\n",
     "        PROBE_STAMP(2)\n", True),
    ("        if constexpr (SPILL) col_fold_rows<4>(spill, ns, nb, c, u_sh, ma, sa, mb, sb);\n",
     "        PROBE_STAMP(3)\n", True),
    ("      // the exchange: CTA `rank` merges", 3, False),
    ("      group_barrier(counter, ++arrivals * G);\n      merge_columns(", 4, "mid"),
    ("[vt, step](int c, float v) { store_tagged(vt + c, v, step + 1); });\n", 5, True),
    ("v_sh[c] = load_tagged(vt + c, step + 1);\n      __syncthreads();\n", 6, True),
])
SPILL_PARTS = ("row step, shared rows", "row step, spilled rows", "column sweep, shared rows",
               "column sweep, spilled rows", "barrier", "merge", "v read")
SPILL_CASES = ((8, 2641), (2, 4096))  # (P, K1): chip_smoke.py phase 3's spilling group cases
# (P, K1) of chip_smoke.py phase 3's group cases timed by ``times``
TIMES_SINKHORN = ((32, 600), (256, 601), (32, 1025), (32, 2640), (8, 2641))

PRELUDE = """
__device__ unsigned long long probe_clocks[16];
extern "C" int probe_clocks_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, probe_clocks, sizeof(probe_clocks));
}
extern "C" int probe_clocks_zero() {
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(probe_clocks, zero, sizeof(zero));
}
#define PROBE_STAMP(i)                                                        \\
  if (PROBE_WHO) {                                                            \\
    const long long probe_now_ = clock64();                                   \\
    atomicAdd(&probe_clocks[i], (unsigned long long)(probe_now_ - probe_t_)); \\
    probe_t_ = probe_now_;                                                    \\
  }
#define PROBE_ADD(i, v) \\
  if (PROBE_WHO) atomicAdd(&probe_clocks[i], (unsigned long long)(v));
"""


def redundant_source() -> str:
    """``csrc/sinkhorn.cu`` with the group path's exchange replaced by the
    redundant merge (each anchor must be found exactly once)."""
    from rdmnet_tpu_torch.ops.kernels._build import source_path

    src = source_path("sinkhorn").read_text()
    for old, new in GROUP_REDUNDANT:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel_probe: {old!r} is not once in sinkhorn.cu")
        src = src.replace(old, new)
    return src


def stamped_source(name: str, stamps, who: str, src: str = None) -> str:
    """``csrc/<name>.cu`` (or ``src``, a copy of it) with ``PROBE_STAMP``
    lines at ``stamps``' anchors, each found exactly once inside its region
    (the copy fails to build rather than time the wrong code when the kernel
    has changed)."""
    from rdmnet_tpu_torch.ops.kernels._build import source_path

    if src is None:
        src = source_path(name).read_text()
    start, end, edits = stamps
    lo = src.index(start)
    hi = src.index(end, lo)
    inserts = []
    for anchor, part, where in edits:
        i = src.index(anchor, lo)
        if i >= hi or src.find(anchor, i + 1, hi) != -1:
            raise RuntimeError(f"kernel_probe: anchor {anchor!r} not once in {name}'s region")
        if part is None:
            text = "  long long probe_t_ = clock64();\n"
        elif isinstance(part, str):  # a line of its own
            text = part
        else:
            text = f"  PROBE_STAMP({part})\n"
        if where == "mid":
            at = i + anchor.index("\n") + 1
        else:
            at = i + len(anchor) if where else i
        inserts.append((at, text))
    for at, text in sorted(inserts, reverse=True):
        src = src[:at] + text + src[at:]
    head = "#include <math_constants.h>\n"
    return src.replace(head, head + f"#define PROBE_WHO ({who})\n" + PRELUDE, 1)


def start_build(name: str, text: str):
    """(library path, nvcc process or None) for a stamped copy."""
    from rdmnet_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, nvcc_path

    digest = hashlib.sha1((text + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libprobe_{name}-{digest}.so"
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"probe_{name}-{digest}.cu"
    src.write_text(text)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(lib: Path, proc) -> ctypes.CDLL:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"kernel_probe: nvcc failed for {lib.name}:\n{log}")
    return ctypes.CDLL(str(lib))


def clocks(lib, n: int):
    buf = (ctypes.c_ulonglong * 16)()
    if lib.probe_clocks_get(buf):
        raise RuntimeError("kernel_probe: reading the clocks failed")
    return [int(buf[i]) for i in range(n)]


def graph_ms(fn, reps: int = REPS) -> float:
    """Mean device ms per call of ``reps`` calls replayed from one CUDA graph."""
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


# ---- searches ------------------------------------------------------------------------------

@dataclasses.dataclass
class Search:
    """One level-0 (or synthetic) radius search on the card."""

    name: str
    q: object
    s: object
    cnt: object
    radius: float
    k: int
    win: object = None
    chunk: int = 0
    band: int = 0
    qcnt: object = None  # valid queries per cloud (cnt when None: a self search)

    def call(self, route: str, plan, out, lib=None):
        import torch

        from rdmnet_tpu_torch.ops.kernels.radius_knn import _radius_sq, launcher, plan_args

        win = self.win
        err = launcher(route, lib)(
            self.q.data_ptr(), self.s.data_ptr(), self.cnt.data_ptr(),
            None if win is None else win.data_ptr(), self.q.shape[0], self.q.shape[1],
            self.s.shape[1], self.k, _radius_sq(self.radius), self.chunk, self.band,
            0 if win is None else win.shape[1], *plan_args(plan), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel_probe: {self.name} {route} launch failed with {err}")

    def plain(self):
        from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_plain

        kw = {} if self.win is None else dict(win=self.win, chunk=self.chunk, band=self.band)
        return radius_knn_plain(self.q, self.s, self.cnt, self.radius, self.k, **kw)

    def bound(self) -> dict:
        """The least time for the search (``knn_bound``, ``chip_smoke.py``'s
        bound), what bounds it and the pairs it counts."""
        ms, by, window, reached = knn_bound(
            self.q, self.s, self.cnt, self.cnt if self.qcnt is None else self.qcnt, self.radius,
            self.k, self.win, self.chunk, self.band)
        return dict(bound_ms=round(ms, 5), bound_by=by, window_pairs=window,
                    reached_pairs=reached)

    def plans(self):
        from rdmnet_tpu_torch.ops.kernels.radius_knn import (LIST_KMAX, block_plan, knn_plan,
                                                             select_plan)

        args = (self.q.shape[0], self.q.shape[1], self.s.shape[1], self.k,
                self.band if self.win is not None else None)
        plans = {"block": block_plan(*args)}
        try:  # the warp select path holds k up to 2048
            plans["select"] = select_plan(*args)
        except ValueError:
            pass
        if self.k <= LIST_KMAX:
            plans["list"] = knn_plan(*args)
        return plans, knn_plan(*args).route


def knn_work(q, s, cnt, qcnt, radius, win=None, chunk=0, band=0):
    """(window pairs, reached pairs) of a search over its valid queries: the
    valid rows of each query's window, and those of the window's 32-row
    chunks (counted from the window's first row, as the kernel cuts them)
    whose bounding box lies within the radius of the query. A row outside
    such a box is outside the radius, so no search need evaluate it."""
    import torch

    from rdmnet_tpu_torch.ops.kernels.radius_knn import _radius_sq

    r2 = _radius_sq(radius)
    bsz, nq, _ = q.shape
    ns = s.shape[1]
    length = ns if win is None else band
    nb = -(-length // 32)
    window = reached = 0
    for b in range(bsz):
        starts = (torch.zeros(1, dtype=torch.long, device=q.device) if win is None
                  else win[b].long())
        rows = starts[:, None] + torch.arange(nb * 32, device=q.device)
        ok = rows < torch.clamp(starts + length, max=int(cnt[b]))[:, None]
        pts = s[b][rows.clamp(max=ns - 1)]
        inf = torch.tensor(float("inf"), device=q.device)
        lo = torch.where(ok[..., None], pts, inf).view(-1, nb, 32, 3).amin(2)
        hi = torch.where(ok[..., None], pts, -inf).view(-1, nb, 32, 3).amax(2)
        n_rows = ok.view(-1, nb, 32).sum(-1)  # (windows, chunks)
        nvq = int(qcnt[b])
        for q0 in range(0, nvq, 2048):  # the queries' boxes gathered piece by piece
            qq = q[b, q0:min(q0 + 2048, nvq)]
            wi = (torch.arange(q0, q0 + qq.shape[0], device=q.device) // chunk
                  if win is not None else torch.zeros(qq.shape[0], dtype=torch.long,
                                                      device=q.device))
            gap = (torch.clamp_min(lo[wi] - qq[:, None], 0)
                   + torch.clamp_min(qq[:, None] - hi[wi], 0))
            near = (gap * gap).sum(-1) <= r2  # an empty chunk's gap is inf
            window += int(n_rows[wi].sum())
            reached += int((n_rows[wi] * near).sum())
    return window, reached


def knn_bound(q, s, cnt, qcnt, radius, k, win=None, chunk=0, band=0):
    """(bound ms, bound_by, window pairs, reached pairs): the least time for
    a search, the longer of 9 float32 operations a pair of the chunks the
    radius reaches (``knn_work``) at the card's float32 rate and the inputs
    and the table moved once at its memory rate."""
    window, reached = knn_work(q, s, cnt, qcnt, radius, win, chunk, band)
    bsz, nq, _ = q.shape
    nbytes = bsz * (nq * 3 * 4 + s.shape[1] * 3 * 4 + nq * k * 4)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, reached * KNN_OPS_PER_PAIR / F32_FLOPS
    return (max(bytes_s, ops_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes", window,
            reached)


def level0_search(name, pts, cnts, spec, k):
    """The level-0 self search of a pair's pyramid at limit ``k``."""
    from rdmnet_tpu_torch.graph.pyramid import search_plan
    from rdmnet_tpu_torch.ops.radius_search import band_windows

    sp = search_plan(spec)[0]
    q, s = pts[0], pts[0]
    kw = {}
    if sp.band is not None:
        win, _ = band_windows(q, s, cnts[0], sp.radius, sp.cell, sp.band, sp.chunk)
        kw = dict(win=win, chunk=sp.chunk, band=sp.band)
    return Search(name, q, s, cnts[0], sp.radius, k, **kw)


def pair_levels(batch, num_stages):
    import torch

    pts = [torch.stack([batch.ref.points[i], batch.src.points[i]]).contiguous()
           for i in range(num_stages)]
    cnts = [torch.stack([batch.ref.counts[i], batch.src.counts[i]]).to(torch.int32)
            for i in range(num_stages)]
    return pts, cnts


def pair_pyramid(ref, src, spec, dev):
    import torch

    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud

    rp, rc = pad_cloud(ref, spec.caps[0], device=dev)
    sp, sc = pad_cloud(src, spec.caps[0], device=dev)
    batch = build_pair_batch(rp, rc, sp, sc, torch.eye(4, device=dev), spec)
    return pair_levels(batch, spec.num_stages)


def calibrated_searches(dev):
    """(a): per voxel, the calibration's limits and band caps, and the
    level-0 search of the sequence's first two scans under them."""
    import numpy as np

    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.data.calibration import calibrate_band_caps, calibrate_neighbor_limits
    from rdmnet_tpu_torch.data.preprocess import voxel_downsample_xyzi
    from rdmnet_tpu_torch.data.procedural import lidar_scan, make_scene, trajectory

    cfg = make_cfg()
    rng = np.random.RandomState(SEED + 40)
    scene = make_scene(rng, corridor_length=max(60.0, CAL_FRAMES * CAL_STEP + 30.0))
    poses = trajectory(rng, CAL_FRAMES, step=CAL_STEP)
    raw = [lidar_scan(scene, poses[i], rng, **CAL_SCAN) for i in range(CAL_FRAMES)]
    out = []
    for voxel in CAL_VOXELS:
        clouds = []
        for i, scan in enumerate(raw):
            pts = voxel_downsample_xyzi(scan, voxel)[:, :3].astype(np.float32)
            n = len(pts)
            if n > cfg.train.point_limit:  # the dataset's random point limit
                pts = pts[np.random.RandomState(i).permutation(n)[:cfg.train.point_limit]]
            clouds.append((np.ascontiguousarray(pts), n))
        sample = [c for c, _ in clouds]
        t0 = time.perf_counter()
        limits = calibrate_neighbor_limits(sample, cfg.pyramid, keep_ratio=0.8, device=dev)
        bands = calibrate_band_caps(sample, cfg.pyramid, device=dev)
        cal_s = time.perf_counter() - t0
        spec = dataclasses.replace(cfg.pyramid, neighbor_limits=limits, band_caps=bands)
        pts, cnts = pair_pyramid(sample[0], sample[1], spec, dev)
        search = level0_search(f"calibrated voxel {voxel}", pts, cnts, spec, limits[0])
        info = dict(voxel=voxel, points_before_limit=[n for _, n in clouds],
                    neighbor_limits=list(limits), band_caps=list(bands),
                    calibrate_s=round(cal_s, 3))
        out.append((search, info))
    return out


def dense_search(dev, k):
    """(c): chip_smoke.py phase 3's tiled band (16000 points in a 10 x 3 x 2 m
    box, x-cell sorted), every list full."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.radius_search import band_windows

    rng = np.random.RandomState(SEED + 22)
    pts = (rng.rand(DENSE["n"], 3) * np.asarray(DENSE["box"])).astype(np.float32)
    pts = pts[np.argsort(np.floor(pts[:, 0] / DENSE["cell"]), kind="stable")]
    s = torch.from_numpy(pts[None]).to(dev).contiguous()
    cnt = torch.tensor([DENSE["n"]], dtype=torch.int32, device=dev)
    win, _ = band_windows(s, s, cnt, DENSE["radius"], DENSE["cell"], DENSE["band"],
                          DENSE["chunk"])
    return Search(f"dense band k={k}", s, s, cnt, DENSE["radius"], k, win, DENSE["chunk"],
                  DENSE["band"])


def time_routes(search, info=None):
    """Both select paths (and the list path at k <= 256) on one search:
    tables against the plain version, device ms, the windows' fill."""
    import torch

    want = search.plain()
    found = (want < search.s.shape[1]).sum(-1)
    full = float((found == min(search.k, search.s.shape[1])).float().mean())
    plans, picked = search.plans()
    row = dict(info or {}, search=search.name, k=search.k, band=search.band or None,
               queries=int(search.q.shape[0] * search.q.shape[1]),
               neighbours_mean=round(float(found.float().mean()), 2),
               neighbours_max=int(found.max()), full_share=round(full, 4), picked=picked,
               **search.bound())
    for route, plan in plans.items():
        out = torch.empty_like(want)
        search.call(route, plan, out)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"kernel_probe: {search.name} {route} table differs from the "
                               "plain version")
        row[f"{route}_ms"] = round(graph_ms(lambda: search.call(route, plan, out)), 4)
        row[f"{route}_plan"] = plan._asdict()
    print(json.dumps(row), flush=True)
    return row


def routes_part(dev, pair_spec, pair_pts, calibrated):
    rows = []
    for search, info in calibrated:
        rows.append(time_routes(search, dict(info, kind="calibrated scan")))
    pts, cnts = pair_pts
    for k in PAIR_KS:
        spec = dataclasses.replace(pair_spec, neighbor_limits=(k,) + pair_spec.neighbor_limits[1:])
        rows.append(time_routes(level0_search(f"phase-4 pair k={k}", pts, cnts, spec, k),
                                dict(kind="phase-4 pair")))
    for k in PAIR_KS:
        rows.append(time_routes(dense_search(dev, k), dict(kind="dense band")))
    from rdmnet_tpu_torch.ops.kernels.radius_knn import BLOCK_K_MIN

    # the threshold beside the faster select path on each window both ran
    faster = {f"{r['kind']} k={r['k']}": min(("select", "block"), key=lambda x: r[f"{x}_ms"])
              for r in rows if "select_ms" in r and "block_ms" in r}
    rows.append(dict(block_k_min=BLOCK_K_MIN, faster=faster))
    print(json.dumps(rows[-1]), flush=True)
    return rows


def select_searches(dev, pair_spec, pair_pts, calibrated):
    """The warp select path's windows: phase 16's two level-0 searches (the
    phase-4 pair at limit ``SELECT_PAIR_K``), the calibrated-scan searches
    whose limit takes the path, and the dense tiled band at ``SELECT_PAIR_K``."""
    from rdmnet_tpu_torch.graph.pyramid import search_plan
    from rdmnet_tpu_torch.ops.kernels.radius_knn import knn_plan

    pts, cnts = pair_pts
    spec = dataclasses.replace(
        pair_spec, neighbor_limits=(SELECT_PAIR_K,) + pair_spec.neighbor_limits[1:])
    out = []
    for sp in search_plan(spec)[:2]:
        kw = {}
        q, s = pts[sp.q_lvl], pts[sp.s_lvl]
        if sp.band is not None:
            from rdmnet_tpu_torch.ops.radius_search import band_windows

            win, _ = band_windows(q, s, cnts[sp.q_lvl], sp.radius, sp.cell, sp.band, sp.chunk)
            kw = dict(win=win, chunk=sp.chunk, band=sp.band)
        out.append(Search(f"phase-16 {sp.table}[{sp.q_lvl}->{sp.s_lvl}] k={sp.k}", q, s,
                          cnts[sp.s_lvl], sp.radius, sp.k, qcnt=cnts[sp.q_lvl], **kw))
    for search, _ in calibrated:
        plan = knn_plan(search.q.shape[0], search.q.shape[1], search.s.shape[1], search.k,
                        search.band if search.win is not None else None)
        if plan.route == "select":
            out.append(search)
    out.append(dense_search(dev, SELECT_PAIR_K))
    return out


def select_split_part(dev, lib, searches):
    """The warp select path's parts (clock64 cycles of every warp's lane 0,
    summed over warps, per query and as shares) and the share of queries
    whose in-radius rows overflow the sort buffer, beside the stamped and the
    kernel's device ms."""
    import torch

    from rdmnet_tpu_torch.ops.kernels.radius_knn import select_plan

    rows = []
    for search in searches:
        plan = select_plan(search.q.shape[0], search.q.shape[1], search.s.shape[1], search.k,
                           search.band if search.win is not None else None)
        want = search.plain()
        out = torch.empty_like(want)
        lib.probe_clocks_zero()
        search.call("select", plan, out, lib)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"kernel_probe: stamped {search.name} differs from plain")
        raw = clocks(lib, SELECT_CHUNKS + 1)
        cyc = raw[:len(SELECT_PARTS)]
        queries = int(search.q.shape[0] * search.q.shape[1])
        total = sum(cyc)
        row = dict(search=search.name, k=search.k, band=search.band or None, queries=queries,
                   plan=plan._asdict(), **search.bound(),
                   overflow_share=round(raw[SELECT_OVERFLOW] / queries, 4),
                   radix_passes_per_overflow=round(raw[SELECT_PASSES]
                                                   / max(raw[SELECT_OVERFLOW], 1), 3),
                   chunks_swept_per_query=round(raw[SELECT_CHUNKS] / queries, 2),
                   window_chunks=-(-(search.band or search.s.shape[1]) // 32),
                   cycles_per_query={p: round(c / queries) for p, c in zip(SELECT_PARTS, cyc)},
                   share={p: round(c / total, 4) for p, c in zip(SELECT_PARTS, cyc)},
                   stamped_ms=round(graph_ms(lambda: search.call("select", plan, out, lib)), 4),
                   kernel_ms=round(graph_ms(lambda: search.call("select", plan, out)), 4))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def knn_split_part(dev, lib, pair_spec, pair_pts):
    """The block select path's parts at k = 2048 (clock64 cycles of thread 0,
    summed over CTAs, and their shares), beside the stamped and the
    kernel's device ms."""
    import torch

    from rdmnet_tpu_torch.ops.kernels.radius_knn import block_plan

    pts, cnts = pair_pts
    spec = dataclasses.replace(pair_spec, neighbor_limits=(2048,) + pair_spec.neighbor_limits[1:])
    rows = []
    for search in (level0_search("phase-4 pair k=2048", pts, cnts, spec, 2048),
                   dense_search(dev, 2048)):
        plan = block_plan(search.q.shape[0], search.q.shape[1], search.s.shape[1], search.k,
                          search.band if search.win is not None else None)
        want = search.plain()
        out = torch.empty_like(want)
        lib.probe_clocks_zero()
        search.call("block", plan, out, lib)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"kernel_probe: stamped {search.name} differs from plain")
        cyc = clocks(lib, len(KNN_PARTS))
        total = sum(cyc)
        row = dict(search=search.name, plan=plan._asdict(),
                   cycles=dict(zip(KNN_PARTS, cyc)),
                   share={p: round(c / total, 4) for p, c in zip(KNN_PARTS, cyc)},
                   stamped_ms=round(graph_ms(lambda: search.call("block", plan, out, lib)), 4),
                   kernel_ms=round(graph_ms(lambda: search.call("block", plan, out)), 4))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def sinkhorn_split_part(dev, lib, max_clock_mhz):
    """The cluster path's parts an iteration (CTA 0's thread 0) at P = 256,
    100 iterations, on chip_smoke.py phase 3's inputs."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda, sinkhorn_plan

    fn = lib.sinkhorn_cluster_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    rows = []
    p, iters = 256, 100
    for k1 in (257, 513):
        rng = np.random.RandomState(SEED + k1)
        scores = (rng.randn(p, k1, k1) * 3).astype(np.float32)
        log_mu = np.full((p, k1), -np.log(2 * (k1 - 1)), np.float32)
        s_t, mu_t = torch.from_numpy(scores).to(dev), torch.from_numpy(log_mu).to(dev)
        nu_t = mu_t.clone()
        out = torch.empty_like(s_t)
        plan = sinkhorn_plan(k1)
        call = lambda: fn(s_t.data_ptr(), mu_t.data_ptr(), nu_t.data_ptr(), p, k1,  # noqa: E731
                          iters, plan.cluster, out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
        lib.probe_clocks_zero()
        if call():
            raise RuntimeError(f"kernel_probe: stamped cluster launch failed at K1={k1}")
        torch.cuda.synchronize()
        want = sinkhorn_cuda(s_t, mu_t, nu_t, iters)
        err = float((out - want).abs().max())
        cyc = [c / iters for c in clocks(lib, len(SKC_PARTS))]
        row = dict(k1=k1, cluster=plan.cluster, max_abs_diff_to_kernel=err,
                   cycles_per_iteration={n: round(c) for n, c in zip(SKC_PARTS, cyc)},
                   us_per_iteration=round(sum(cyc) / max_clock_mhz, 3),
                   stamped_ms=round(graph_ms(call), 4),
                   kernel_ms=round(graph_ms(lambda: sinkhorn_cuda(s_t, mu_t, nu_t, iters)), 4))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def group_call(lib, args, iters, out, redundant=False):
    """One group-path launch of ``lib``'s ``sinkhorn_group_launch`` (the
    kernel's library or a copy's) with the wrapper's grid and scratch; the
    redundant copy's scratch holds a second buffer of partials."""
    import torch

    from rdmnet_tpu_torch.ops.kernels.sinkhorn import BAR_STRIDE, group_resident, sinkhorn_plan

    p, k1 = args[0].shape[0], args[0].shape[1]
    plan = sinkhorn_plan(k1)
    groups = min(p, group_resident(k1, args[0].device.index) // plan.group)
    floats = plan.scratch_floats + (2 * plan.group * k1 if redundant else 0)
    scratch = torch.zeros((groups, floats), device=args[0].device)
    counters = torch.zeros((groups, BAR_STRIDE), dtype=torch.int32, device=args[0].device)
    fn = lib.sinkhorn_group_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    err = fn(*[a.data_ptr() for a in args], p, k1, iters, plan.group, plan.spill_rows, groups,
             scratch.data_ptr(), counters.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel_probe: group launch failed with {err}")
    return groups


def group_split_part(dev, libs, max_clock_mhz):
    """The group path at P = ``GROUP_P``, K1 in ``GROUP_K1S``, 100 iterations
    (chip_smoke.py phase 3's inputs): the kernel's device ms beside the
    redundant-merge copy's, and each design's parts an iteration (CTA 0's
    thread 0, averaged over the iterations of every patch its group takes)."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.kernels._build import load_library
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_plain, sinkhorn_plan

    rows = []
    p, iters = GROUP_P, 100
    for k1 in GROUP_K1S:
        rng = np.random.RandomState(SEED + k1)
        scores = (rng.randn(p, k1, k1) * 3).astype(np.float32)
        log_mu = np.full((p, k1), -np.log(2 * (k1 - 1)), np.float32)
        args = [torch.from_numpy(x).to(dev) for x in (scores, log_mu, log_mu.copy())]
        want = sinkhorn_plain(*args, iters)
        out = torch.empty_like(want)
        row = dict(k1=k1, p=p, group=sinkhorn_plan(k1).group)
        for design, parts, lib_k, stamped_k in (
                ("reduce-scatter", GROUP_PARTS, "sinkhorn", "group_stamped"),
                ("redundant", REDUNDANT_PARTS, "redundant", "redundant_stamped")):
            lib = load_library("sinkhorn") if lib_k == "sinkhorn" else libs[lib_k]
            red = design == "redundant"
            groups = group_call(lib, args, iters, out, red)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if err > 1e-4:
                raise RuntimeError(f"kernel_probe: {design} at K1={k1} is {err} from plain")
            ms = graph_ms(lambda: group_call(lib, args, iters, out, red))
            stamped = libs[stamped_k]
            stamped.probe_clocks_zero()
            group_call(stamped, args, iters, out, red)
            torch.cuda.synchronize()
            n_it = iters * len(range(0, p, groups))  # CTA 0's iterations, every patch
            cyc = [c / n_it for c in clocks(stamped, len(parts))]
            row[design] = dict(ms=round(ms, 4), max_abs_err=err, groups=groups,
                               cycles_per_iteration={n: round(c) for n, c in zip(parts, cyc)},
                               us_per_iteration=round(sum(cyc) / max_clock_mhz, 3),
                               stamped_ms=round(graph_ms(lambda: group_call(stamped, args,
                                                                            iters, out, red)),
                                                4))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def spill_split_part(dev, lib, max_clock_mhz):
    """The group path past K1 = 2640 at ``SPILL_CASES``, 100 iterations
    (chip_smoke.py phase 3's unmasked inputs): the kernel's device ms, and its
    parts an iteration (CTA 0's thread 0) with the row step's and the column
    sweep's shared and spilled rows apart; the stamped copy's barrier after
    the shared rows' row step keeps the spilled rows from overlapping them."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.kernels._build import load_library
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_plain, sinkhorn_plan

    rows, iters = [], 100
    for p, k1 in SPILL_CASES:
        rng = np.random.RandomState(SEED + k1)
        scores = (rng.randn(p, k1, k1) * 3).astype(np.float32)
        log_mu = np.full((p, k1), -np.log(2 * (k1 - 1)), np.float32)
        args = [torch.from_numpy(x).to(dev) for x in (scores, log_mu, log_mu.copy())]
        want = sinkhorn_plain(*args, iters)
        out = torch.empty_like(want)
        plan = sinkhorn_plan(k1)
        kernel = load_library("sinkhorn")
        groups = group_call(kernel, args, iters, out)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if err > 1e-4:
            raise RuntimeError(f"kernel_probe: the group path at K1={k1} is {err} from plain")
        ms = graph_ms(lambda: group_call(kernel, args, iters, out), reps=2)
        lib.probe_clocks_zero()
        group_call(lib, args, iters, out)
        torch.cuda.synchronize()
        n_it = iters * len(range(0, p, groups))
        cyc = [c / n_it for c in clocks(lib, len(SPILL_PARTS))]
        band = -(-k1 // plan.group)
        row = dict(k1=k1, p=p, group=plan.group, band_rows=band,
                   spill_rows=plan.spill_rows, groups=groups, ms=round(ms, 4),
                   max_abs_err=err,
                   cycles_per_iteration={n: round(c) for n, c in zip(SPILL_PARTS, cyc)},
                   us_per_iteration=round(sum(cyc) / max_clock_mhz, 3),
                   stamped_ms=round(graph_ms(lambda: group_call(lib, args, iters, out), reps=2),
                                    4))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def times_part(dev, pair_spec, pair_pts, calibrated):
    """Device ms through the public wrappers (``radius_knn_cuda``,
    ``sinkhorn_cuda``), each result held against the plain version: the warp
    select path's windows (``select_searches``) and Sinkhorn at
    ``TIMES_SINKHORN``. It uses nothing but what every version of the port
    has, so run as a file with another tree first on ``PYTHONPATH`` it times
    that tree's kernels, in the same call as this one's."""
    import numpy as np
    import torch

    import rdmnet_tpu_torch
    from rdmnet_tpu_torch.ops.kernels.radius_knn import knn_plan, radius_knn_cuda
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda, sinkhorn_plain, sinkhorn_plan

    rows = [dict(package=str(Path(rdmnet_tpu_torch.__file__).parent))]
    print(json.dumps(rows[0]), flush=True)
    for sr in select_searches(dev, pair_spec, pair_pts, calibrated):
        kw = {} if sr.win is None else dict(win=sr.win, chunk=sr.chunk, band=sr.band)
        call = lambda: radius_knn_cuda(sr.q, sr.s, sr.cnt, sr.radius, sr.k, **kw)  # noqa: E731
        if not torch.equal(call(), sr.plain()):
            raise RuntimeError(f"kernel_probe: {sr.name} differs from the plain version")
        plan = knn_plan(sr.q.shape[0], sr.q.shape[1], sr.s.shape[1], sr.k,
                        sr.band if sr.win is not None else None)
        rows.append(dict(search=sr.name, route=plan.route, ms=round(graph_ms(call), 4),
                         **sr.bound()))
        print(json.dumps(rows[-1]), flush=True)
    for p, k1 in TIMES_SINKHORN:
        rng = np.random.RandomState(SEED + k1)
        scores = (rng.randn(p, k1, k1) * 3).astype(np.float32)
        log_mu = np.full((p, k1), -np.log(2 * (k1 - 1)), np.float32)
        args = [torch.from_numpy(x).to(dev) for x in (scores, log_mu, log_mu.copy())]
        err = float((sinkhorn_cuda(*args, 100) - sinkhorn_plain(*args, 100)).abs().max())
        if err > 1e-4:
            raise RuntimeError(f"kernel_probe: sinkhorn at K1={k1} is {err} from plain")
        rows.append(dict(p=p, k1=k1, route=sinkhorn_plan(k1).route, max_abs_err=err,
                         ms=round(graph_ms(lambda: sinkhorn_cuda(*args, 100), reps=2), 4)))
        print(json.dumps(rows[-1]), flush=True)
        del args
    return rows


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts",
                        default="routes,select_split,knn_split,sinkhorn_split,group_split,"
                                "spill_split")
    parser.add_argument("--out", default=None, help="write the rows as JSON here too")
    args = parser.parse_args(argv)
    parts = args.parts.split(",")

    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.data.loader import choose_bucket
    from rdmnet_tpu_torch.data.procedural import procedural_pair
    from rdmnet_tpu_torch.ops.kernels._build import KERNELS, Build

    card = smi("name,power.limit")
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"kernel_probe on {card}, max SM clock {max_clock_mhz:.0f} MHz", flush=True)
    t0 = time.perf_counter()
    builds = [Build(name) for name in KERNELS]
    copies = {}
    if "select_split" in parts:
        copies["select"] = start_build(
            "radius_knn_select", stamped_source("radius_knn", SELECT_STAMPS,
                                                "(threadIdx.x & 31) == 0"))
    if "knn_split" in parts:
        copies["radius_knn"] = start_build(
            "radius_knn", stamped_source("radius_knn", KNN_STAMPS, "threadIdx.x == 0"))
    if "sinkhorn_split" in parts:
        copies["sinkhorn"] = start_build(
            "sinkhorn", stamped_source("sinkhorn", SKC_STAMPS,
                                       "blockIdx.x == 0 && threadIdx.x == 0"))
    if "spill_split" in parts:
        copies["spill_stamped"] = start_build(
            "sinkhorn_spill", stamped_source("sinkhorn", SPILL_STAMPS,
                                             "blockIdx.x == 0 && threadIdx.x == 0"))
    if "group_split" in parts:
        who = "blockIdx.x == 0 && threadIdx.x == 0"
        copies["redundant"] = start_build("sinkhorn_redundant", redundant_source())
        copies["group_stamped"] = start_build(
            "sinkhorn_group", stamped_source("sinkhorn", GROUP_STAMPS, who))
        copies["redundant_stamped"] = start_build(
            "sinkhorn_redundant_stamped",
            stamped_source("sinkhorn", REDUNDANT_STAMPS, who, redundant_source()))
    for b in builds:
        for line in b.wait().splitlines():  # the -Xptxas -v report
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"[{b.name}] {line.strip()}", flush=True)
    libs = {name: finish_build(*c) for name, c in copies.items()}
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)

    dev = torch.device("cuda")
    ref, src, _ = procedural_pair(SEED, n_rings=80, n_azimuths=3000)
    cfg = make_cfg()
    buckets = [cfg.pyramid.scaled(0.7), cfg.pyramid]
    spec = buckets[choose_bucket(max(len(ref), len(src)), [b.caps[0] for b in buckets])]
    pair_pts = pair_pyramid(ref, src, spec, dev)
    result = dict(card=card, max_sm_clock_mhz=max_clock_mhz)
    calibrated = (calibrated_searches(dev) if {"routes", "select_split", "times"} & set(parts)
                  else [])
    if "times" in parts:
        result["times"] = times_part(dev, spec, pair_pts, calibrated)
    if "routes" in parts:
        result["routes"] = routes_part(dev, spec, pair_pts, calibrated)
    if "select_split" in parts:
        result["select_split"] = select_split_part(
            dev, libs["select"], select_searches(dev, spec, pair_pts, calibrated))
    if "knn_split" in parts:
        result["knn_split"] = knn_split_part(dev, libs["radius_knn"], spec, pair_pts)
    if "sinkhorn_split" in parts:
        result["sinkhorn_split"] = sinkhorn_split_part(dev, libs["sinkhorn"], max_clock_mhz)
    if "group_split" in parts:
        result["group_split"] = group_split_part(dev, libs, max_clock_mhz)
    if "spill_split" in parts:
        result["spill_split"] = spill_split_part(dev, libs["spill_stamped"], max_clock_mhz)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
