"""Radius-bounded kNN: CUDA kernel wrapper and its plain PyTorch version.

Kernel: ``csrc/radius_knn.cu`` (replaces ``rdmnet_tpu/ops/pallas/
radius_knn.py`` radius_knn_pallas). Both versions compute, per cloud b of a
batch and per query, the ``k`` nearest support rows j inside the query's
window with ``j < s_count[b]`` and squared distance <= radius^2, in
ascending (distance, index) order, sentinel ``S`` where missing.

Windows: ``win`` (B, n_chunks) int32 gives the first support row seen by
each chunk of ``chunk`` consecutive queries, which then see ``band`` rows;
``win=None`` searches all S rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from rdmnet_tpu_torch.ops.geometry import dot3, sq_norm3
from rdmnet_tpu_torch.ops.kernels._build import check, load_library

KMAX = 256  # largest k the kernel takes
NUM_SMS = 132  # H100 SXM
WINDOW_ROWS_MAX = 7168  # rows staged at once: 112 KB (the 1.0 bucket's level-0 band), 2 blocks/SM
ROW_BYTES = 16  # a staged support row: float4 (x, y, z, |s|^2)


class KnnPlan(NamedTuple):
    """How ``csrc/radius_knn.cu`` runs one search."""

    warps: int  # queries (one warp each) per block; divides the query chunk
    k_bucket: int  # length of the register-resident top-K list: 1, 32, 64, 128 or 256
    tile_rows: int  # support rows staged in shared memory at once
    tiled: bool  # the window is larger than one tile and is swept tile by tile
    smem_bytes: int


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
    """
    if not 1 <= k <= KMAX:
        raise ValueError(f"radius_knn: k={k} outside [1, {KMAX}]")
    rows = ns if band is None else band
    tile_rows = max(1, min(rows, WINDOW_ROWS_MAX))
    warps = next((w for w in (16, 8) if batch * -(-nq // w) >= 2 * NUM_SMS), 4)
    k_bucket = 1 if k == 1 else next(kb for kb in (32, 64, 128, 256) if k <= kb)
    return KnnPlan(warps, k_bucket, tile_rows, rows > WINDOW_ROWS_MAX, tile_rows * ROW_BYTES)


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
def _launcher():
    fn = load_library("radius_knn").radius_knn_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def radius_knn_cuda(q, s, s_count, radius, k, win=None, chunk=0, band=0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (one launch per call)."""
    for name, t, dt in (("q", q, torch.float32), ("s", s, torch.float32),
                        ("s_count", s_count, torch.int32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"radius_knn_cuda: {name} must be a contiguous CUDA {dt} tensor")
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), s.data_ptr(), s_count.data_ptr(),
                      None if win is None else win.data_ptr(),
                      bsz, nq, ns, k, _radius_sq(radius), chunk, band, n_chunks,
                      plan.warps, plan.k_bucket, plan.tile_rows, out.data_ptr(), stream)
    check(err, "radius_knn")
    radius_knn_cuda.launches += 1
    return out


radius_knn_cuda.launches = 0


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
