"""Padded radius-bounded kNN search (twin of ``rdmnet_tpu/ops/radius_search.py``).

For each query, the support rows within ``radius`` sorted by ascending
distance, ties by lower index; missing neighbours carry the sentinel S (the
support capacity). The search itself is ``ops/kernels/radius_knn``: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors. This module adds
the banded window logic in plain torch.

Always exact: the JAX package's ``approx_recall`` (``lax.approx_max_k``)
has no PyTorch counterpart, so it is not an argument here.

Inputs may be one cloud ((Q, 3), s_count ()) or a batch ((B, Q, 3), (B,)).
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.geometry import f32_reciprocal
from benchmark.reference.kernels import radius_knn_batched

# Clamp for x before cell quantisation: keeps the cells of the 1e9 pad rows
# inside int32 while preserving order.
X_CLAMP = 5.0e5


def _batched(q, s, s_count):
    single = q.dim() == 2
    if single:
        q, s, s_count = q[None], s[None], s_count.reshape(1)
    return single, q, s, s_count.to(torch.int64)


def radius_knn(q_points, s_points, s_count, radius: float, k: int) -> torch.Tensor:
    """Radius-bounded kNN indices of ``q_points`` into ``s_points`` -> (.., Q, k) int32."""
    single, q, s, cnt = _batched(q_points, s_points, s_count)
    out = radius_knn_batched(q, s, cnt, radius, k)
    return out[0] if single else out


def band_margin(radius: float, cell: float) -> int:
    """Cells of margin around a chunk's x-cell span (radius in cells + 1)."""
    return int(-(-radius // cell)) + 1


def band_windows(q, s, q_count, radius: float, cell: float, band_cap: int, chunk_size: int):
    """First support row of each query chunk's window and the overflow.

    q (B, Q, 3), s (B, S, 3) with s x-cell sorted and pads (x = 1e9) last;
    q_count (B,) or None. Returns (win (B, n_chunks) int32, overflow (B,)
    int32 = support rows outside an overflowing band, summed over chunks).
    Overflowing bands are centred on the chunk's true band.
    """
    bsz, nq, _ = q.shape
    ns = s.shape[1]
    inv = f32_reciprocal(cell, q)
    s_cells = torch.floor(torch.clamp(s[..., 0], -X_CLAMP, X_CLAMP) * inv).to(torch.int64)
    q_cells = torch.floor(torch.clamp(q[..., 0], -X_CLAMP, X_CLAMP) * inv).to(torch.int64)
    pos = torch.arange(nq, device=q.device)
    if q_count is None:
        q_valid = torch.ones((bsz, nq), dtype=torch.bool, device=q.device)
    else:
        q_valid = pos[None, :] < q_count.reshape(bsz, 1)

    n_chunks = -(-nq // chunk_size)
    pad = n_chunks * chunk_size - nq
    qc = torch.nn.functional.pad(q_cells, (0, pad)).reshape(bsz, n_chunks, chunk_size)
    qv = torch.nn.functional.pad(q_valid, (0, pad)).reshape(bsz, n_chunks, chunk_size)

    margin = band_margin(radius, cell)
    big = 2 ** 31 - 1
    lo = torch.where(qv, qc, torch.full_like(qc, big)).amin(dim=2) - margin
    hi = torch.where(qv, qc, torch.full_like(qc, -big)).amax(dim=2) + margin
    start = torch.searchsorted(s_cells.contiguous(), lo.contiguous(), side="left")
    end = torch.searchsorted(s_cells.contiguous(), hi.contiguous(), side="right")
    win = torch.where(end - start <= band_cap, start,
                      torch.div(start + end - band_cap, 2, rounding_mode="floor"))
    win = torch.clamp(win, 0, ns - band_cap)
    overflow = torch.clamp_min(end - start - band_cap, 0).sum(dim=1)
    return win.to(torch.int32), overflow.to(torch.int32)


def radius_knn_banded(q_points, s_points, s_count, radius: float, k: int, cell: float,
                      band_cap: int, q_count=None, chunk_size: int = 512):
    """Radius kNN against an x-sorted support, banded per query chunk.

    Each chunk of ``chunk_size`` queries sees only the ``band_cap`` support
    rows around its x-cell span (the framework's x-major ordering makes that
    a contiguous row range). Falls back to the full search when
    ``band_cap >= S``. Returns ((.., Q, k) int32 indices, overflow).
    """
    single, q, s, cnt = _batched(q_points, s_points, s_count)
    ns = s.shape[1]
    if band_cap >= ns:
        out = radius_knn_batched(q, s, cnt, radius, k)
        overflow = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    else:
        assert k <= band_cap, f"k={k} exceeds band_cap={band_cap}"
        qcnt = None if q_count is None else q_count.reshape(q.shape[0])
        win, overflow = band_windows(q, s, qcnt, radius, cell, band_cap, chunk_size)
        out = radius_knn_batched(q, s, cnt, radius, k, win=win, chunk=chunk_size,
                                 band=band_cap)
    if single:
        return out[0], overflow[0]
    return out, overflow
