"""Radius-bounded kNN: CUDA kernel wrapper and its plain PyTorch version.

Kernel: ``csrc/radius_knn.cu`` (replaces ``rdmnet_tpu/ops/pallas/
radius_knn.py`` radius_knn_pallas). Both versions compute, per cloud b of a
batch and per query, the ``k`` nearest support rows j inside the query's
window with ``j < s_count[b]`` and squared distance <= radius^2, in
ascending (distance, index) order, sentinel ``S`` where missing.

Windows: ``win`` (B, n_chunks) int32 gives the first support row seen by
each chunk of ``chunk`` consecutive queries, which then see ``band`` rows;
``win=None`` searches all S rows.

The kernel has three paths, chosen by ``knn_plan``: k <= ``LIST_KMAX`` keeps a
sorted list in a warp's registers; up to ``BLOCK_K_MIN`` the warp select path
(a warp per query over the window's 32-row chunks whose bounding boxes its
radius reaches: count, a radix select only when the in-radius rows overflow
the warp's sort buffer, sort); past it the block select path (a CTA per
query: the in-radius keys cached in shared memory, a radix select and a
radix sort by the whole block), for any k.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from rdmnet_tpu_torch.ops.geometry import dot3, sq_norm3
from rdmnet_tpu_torch.ops.kernels._build import check, load_library

LIST_KMAX = 256  # longest register list; a larger k takes a select path
NUM_SMS = 132  # H100 SXM
WINDOW_ROWS_MAX = 7168  # rows staged at once: 112 KB (the 1.0 bucket's level-0 band), 2 blocks/SM
ROW_BYTES = 16  # a staged support row: float4 (x, y, z, |s|^2)
SELECT_BINS = 256  # select paths: a radix histogram
SMEM_MAX = 232_448  # dynamic shared memory a block may take (227 KB)
SELECT_BOX_ROWS_MAX = 32768  # warp select path: window rows whose chunk boxes a block keeps (32 KB)
SELECT_BLOCK_BYTES = 115_712  # warp select path: a block's shared memory, so that two share an SM
# the smallest k on the block select path. Below it the warp select path is
# faster on every window from scans measured (procedural scans calibrated
# as the preprocess CLI does, limits 290 and 423; the phase-4 pair at limits
# 320 to 1024). No scan window calibrated past 1024 has been measured: the
# phase-4 pair at 1536 and 2048 holds 32-182 neighbours a query, and on
# every window whose lists fill past 1024 the block path is faster (PERF.md,
# section 6; tools/kernel_probe.py --parts routes).
BLOCK_K_MIN = 1025
BLOCK_WARPS = 16  # block select path: a CTA of 16 warps per query
BLOCK_CACHE_KEYS_MAX = 8192  # block select path: in-radius keys a CTA caches (64 KB)
BLOCK_SORT_ROWS_MAX = 4096  # block select path: keys a CTA sorts at once (32 KB)
ROUTES = ("list", "select", "block")


class KnnPlan(NamedTuple):
    """How ``csrc/radius_knn.cu`` runs one search."""

    warps: int  # queries (one warp each) per block; divides the query chunk
    k_bucket: int  # length of the register-resident top-K list: 1, 32, 64, 128, 256; 0: select
    tile_rows: int  # list path: support rows staged in shared memory at once, else 0
    tiled: bool  # the window passes tile_rows, box_rows or cache_keys and is swept in parts
    smem_bytes: int
    sort_rows: int = 0  # select paths: keys a warp (CTA) sorts at once (0 on the register path)
    route: str = "list"  # "list", "select" (a warp per query) or "block" (a CTA per query)
    cache_keys: int = 0  # block path: in-radius keys a CTA caches
    box_rows: int = 0  # warp select path: window rows whose 32-row chunk boxes a block holds at once


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _spread(batch: int, nq: int, warps: int) -> bool:
    return batch * -(-nq // warps) >= 2 * NUM_SMS


@functools.lru_cache(maxsize=256)
def knn_plan(batch: int, nq: int, ns: int, k: int, band: Optional[int] = None) -> KnnPlan:
    """Launch plan of one search (pure; the CPU tests call it).

    A window of ``band`` rows (``ns`` when unbanded) that fits in
    ``WINDOW_ROWS_MAX`` rows is staged whole and swept once per query;
    a larger one is swept in tiles of that many rows. Blocks hold 16, 8 or 4
    warps: the most that still makes at least two blocks per SM, so small
    searches spread over the card. Every choice divides 64, hence the query
    chunk. The list bucket is the smallest of 32, 64, 128, 256 that holds k
    (1 for k = 1, which keeps one best per lane instead).

    ``LIST_KMAX`` < k < ``BLOCK_K_MIN`` takes the warp select path
    (``select_plan``), a larger k the block select path (``block_plan``).
    """
    if k < 1:
        raise ValueError(f"radius_knn: k={k} must be at least 1")
    if k > LIST_KMAX:
        return (select_plan if k < BLOCK_K_MIN else block_plan)(batch, nq, ns, k, band)
    rows = ns if band is None else band
    tile_rows = max(1, min(rows, WINDOW_ROWS_MAX))
    warps = next((w for w in (16, 8) if _spread(batch, nq, w)), 4)
    k_bucket = 1 if k == 1 else next(kb for kb in (32, 64, 128, 256) if k <= kb)
    return KnnPlan(warps, k_bucket, tile_rows, rows > WINDOW_ROWS_MAX, tile_rows * ROW_BYTES)


def select_plan(batch: int, nq: int, ns: int, k: int, band: Optional[int] = None) -> KnnPlan:
    """The warp select path's plan: the bounding boxes (32 bytes) of the
    window's 32-row chunks, ``box_rows`` = the window rounded up to 32 rows
    and at most ``SELECT_BOX_ROWS_MAX`` at once (``tiled`` past it), and each
    warp a sort buffer of ``sort_rows`` = next_pow2(k) keys, at least 128
    (the whole output; its first 1 KB doubles as the radix histogram), so
    the block holds as many of 16, 8, 4 warps as spread the search and fit
    in ``SELECT_BLOCK_BYTES``, two blocks an SM. ``knn_plan`` takes it for
    k below ``BLOCK_K_MIN``; the kernel runs any k whose plan fits."""
    rows = ns if band is None else band
    box_rows = min(-(-max(rows, 1) // 32) * 32, SELECT_BOX_ROWS_MAX)
    sort_rows = max(128, _pow2(k))
    per_warp = sort_rows * 8
    fits = lambda w: box_rows + w * per_warp <= SELECT_BLOCK_BYTES  # noqa: E731
    warps = next((w for w in (16, 8) if _spread(batch, nq, w) and fits(w)), 4)
    if not fits(warps):
        raise ValueError(f"radius_knn: k={k} does not fit the warp select path")
    return KnnPlan(warps, 0, 0, rows > box_rows, box_rows + warps * per_warp, sort_rows,
                   "select", box_rows=box_rows)


def block_plan(batch: int, nq: int, ns: int, k: int, band: Optional[int] = None) -> KnnPlan:
    """The block select path's plan, for any k: a CTA of ``BLOCK_WARPS``
    warps per query, no staged window, a cache of min(next_pow2(window),
    ``BLOCK_CACHE_KEYS_MAX``) in-radius keys, a sort buffer of
    min(next_pow2(k), ``BLOCK_SORT_ROWS_MAX``) keys and a radix histogram a
    warp (``tiled``: the window may hold more in-radius rows than the
    cache). ``knn_plan`` takes it from ``BLOCK_K_MIN``."""
    rows = ns if band is None else band
    cache_keys = max(32, min(_pow2(rows), BLOCK_CACHE_KEYS_MAX))
    sort_rows = max(32, min(_pow2(k), BLOCK_SORT_ROWS_MAX))
    smem = (cache_keys + sort_rows) * 8 + BLOCK_WARPS * SELECT_BINS * 4
    return KnnPlan(BLOCK_WARPS, 0, 0, rows > cache_keys, smem, sort_rows, "block", cache_keys)


def _radius_sq(radius: float) -> float:
    # the JAX package rounds the Python-float r*r to float32 once
    return float(np.float32(radius * radius))


def radius_knn_plain(q, s, s_count, radius, k, win=None, chunk=0, band=0,
                     rows_per_piece: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch version: exact distances (``geometry.dot3``), masked,
    then a stable sort — ties keep the lower index, as ``lax.top_k`` does.

    q (B, Q, 3), s (B, S, 3) float32; s_count (B,) int -> (B, Q, k) int32.
    """
    bsz, nq, _ = q.shape
    ns = s.shape[1]
    r2 = torch.tensor(_radius_sq(radius), dtype=torch.float32, device=q.device)
    out = torch.full((bsz, nq, k), ns, dtype=torch.int32, device=q.device)
    length = ns if win is None else band
    step = chunk if win is not None else max(1, rows_per_piece // max(ns, 1))
    counts = [int(c) for c in s_count]
    for b in range(bsz):
        s_sq = sq_norm3(s[b])
        for c0 in range(0, nq, step):
            qq = q[b, c0:c0 + step]
            w = 0 if win is None else int(win[b, c0 // chunk])
            ss, ssq = s[b, w:w + length], s_sq[w:w + length]
            xy = dot3(qq[:, None, :], ss[None, :, :])
            d = torch.clamp_min((sq_norm3(qq)[:, None] - 2.0 * xy) + ssq[None, :], 0.0)
            rows = w + torch.arange(ss.shape[0], device=q.device)
            ok = (d <= r2) & (rows < counts[b])[None, :]
            d = torch.where(ok, d, torch.full_like(d, float("inf")))
            kk = min(k, ss.shape[0])
            vals, idx = torch.sort(d, dim=1, stable=True)
            vals, idx = vals[:, :kk], idx[:, :kk]
            res = torch.where(torch.isfinite(vals), idx + w, torch.full_like(idx, ns))
            out[b, c0:c0 + qq.shape[0], :kk] = res.to(torch.int32)
    return out


@functools.lru_cache(maxsize=None)
def launcher(route: str, lib: Optional[ctypes.CDLL] = None):
    """The C launch function of a path, from the kernel library (or ``lib``,
    a library built from another copy of the source)."""
    lib = lib or load_library("radius_knn")
    fn = getattr(lib, {"list": "radius_knn_launch", "select": "radius_knn_select_launch",
                       "block": "radius_knn_block_launch"}[route])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] \
        + [ctypes.c_int] * (5 if route == "block" else 6) + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def plan_args(plan: KnnPlan) -> tuple:
    """The launch function's plan arguments, in its order."""
    if plan.route == "block":
        return plan.cache_keys, plan.sort_rows
    if plan.route == "select":
        return plan.warps, plan.sort_rows, plan.box_rows
    return plan.warps, plan.k_bucket, plan.tile_rows


def radius_knn_cuda(q, s, s_count, radius, k, win=None, chunk=0, band=0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the tensors' card (one
    launch per call, on the path ``knn_plan`` picks), whichever device is
    current. ``launches`` counts every launch, ``path_launches`` each path's
    ("list", "select", "block")."""
    for name, t, dt in (("q", q, torch.float32), ("s", s, torch.float32),
                        ("s_count", s_count, torch.int32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"radius_knn_cuda: {name} must be a contiguous CUDA {dt} tensor")
    if s.device != q.device or s_count.device != q.device:
        raise ValueError("radius_knn_cuda: q, s and s_count must lie on one card")
    bsz, nq, _ = q.shape
    ns = s.shape[1]
    if q.shape[-1] != 3 or s.shape[-1] != 3 or s.shape[0] != bsz or s_count.shape != (bsz,):
        raise ValueError("radius_knn_cuda: expected q (B, Q, 3), s (B, S, 3), s_count (B,)")
    n_chunks = 0
    if win is not None:
        if (not win.is_cuda or win.dtype != torch.int32 or not win.is_contiguous()
                or chunk % 64 or band <= 0):
            raise ValueError("radius_knn_cuda: win must be contiguous CUDA int32, "
                             "chunk a multiple of 64 and band > 0")
        n_chunks = win.shape[1]
    plan = knn_plan(bsz, nq, ns, k, None if win is None else band)
    out = torch.empty((bsz, nq, k), dtype=torch.int32, device=q.device)
    # the launch goes to the current device: make it the tensors' card, whose
    # stream it is handed
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launcher(plan.route)(
            q.data_ptr(), s.data_ptr(), s_count.data_ptr(),
            None if win is None else win.data_ptr(), bsz, nq, ns, k, _radius_sq(radius), chunk,
            band, n_chunks, *plan_args(plan), out.data_ptr(), stream)
    check(err, "radius_knn")
    radius_knn_cuda.launches += 1
    radius_knn_cuda.path_launches[plan.route] += 1
    return out


radius_knn_cuda.launches = 0
radius_knn_cuda.path_launches = dict.fromkeys(ROUTES, 0)


def radius_knn_batched(q, s, s_count, radius, k, win: Optional[torch.Tensor] = None,
                       chunk: int = 0, band: int = 0) -> torch.Tensor:
    """Route by device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. No fallback: a failing launch raises."""
    if q.is_cuda:
        return radius_knn_cuda(q.contiguous(), s.contiguous(),
                               s_count.to(torch.int32).contiguous(), radius, k,
                               None if win is None else win.to(torch.int32).contiguous(),
                               chunk, band)
    if q.device.type != "cpu":
        raise ValueError(f"radius_knn: unsupported device {q.device}")
    return radius_knn_plain(q, s, s_count, radius, k, win, chunk, band)
