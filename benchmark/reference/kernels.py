"""Plain versions of the port's five hand-written kernels, frozen here so the
reference never reaches the program: the voxel sums, the radius kNN, the NMS
peeling, Horn's top eigenvector and the log-domain Sinkhorn. Each runs in
plain PyTorch on any device."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark.reference.ops.geometry import dot3, sq_norm3


def segment_sums(points: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """points (B, N, 3) float32 sorted by segment, start and length (B, cap)
    int -> (B, cap, 3) sums. Step j adds each segment's j-th row in one
    elementwise float32 add (+0 past its length)."""
    b, n, _ = points.shape
    cap = start.shape[1]
    start = start.long()
    sums = torch.zeros((b, cap, 3), dtype=points.dtype, device=points.device)
    steps = int(length.max()) if b * cap > 0 else 0
    for j in range(steps):
        take = torch.clamp(start + j, max=n - 1)
        row = torch.gather(points, 1, take[..., None].expand(b, cap, 3))
        row = torch.where((j < length)[..., None], row, torch.zeros_like(row))
        sums = sums + row
    return sums


def radius_sq(radius: float) -> float:
    # r*r rounded to float32 once, as the JAX package does
    return float(np.float32(radius * radius))


def radius_knn_batched(q, s, s_count, radius, k, win=None, chunk=0, band=0,
                       rows_per_piece: int = 1 << 22) -> torch.Tensor:
    """Exact distances, masked, then a stable sort: ties keep the lower
    index. q (B, Q, 3), s (B, S, 3) float32; s_count (B,) int -> (B, Q, k)
    int32, the support count S past the last neighbour."""
    bsz, nq, _ = q.shape
    ns = s.shape[1]
    r2 = torch.tensor(radius_sq(radius), dtype=torch.float32, device=q.device)
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


def nms_peel(adj_earlier: torch.Tensor,
             nodes_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy NMS peeling as a loop: each round keeps the active nodes
    with no earlier active neighbour and drops what they cover."""
    adj = adj_earlier.float()
    keep = torch.zeros_like(nodes_mask)
    active = nodes_mask.clone()
    rounds = 0
    while bool(active.any()):
        has_earlier_active = (adj @ active.float()[..., None])[..., 0] > 0.0
        confirm = active & ~has_earlier_active
        killed = (adj @ confirm.float()[..., None])[..., 0] > 0.0
        keep = keep | confirm
        active = active & ~confirm & ~killed
        rounds += 1
    return keep, torch.full((), rounds, dtype=torch.int32, device=nodes_mask.device)


def top_eigenvector(k: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 4), ``torch.linalg.eigh``'s largest eigenvector."""
    return torch.linalg.eigh(k).eigenvectors[..., -1]


def _lse(t: torch.Tensor, dim: int) -> torch.Tensor:
    # the shift carries no gradient, as in jax.nn.logsumexp
    m = t.amax(dim=dim, keepdim=True).detach()
    return (m + torch.log(torch.exp(t - m).sum(dim=dim, keepdim=True))).squeeze(dim)


def sinkhorn_plain(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                   num_iterations: int) -> torch.Tensor:
    """(P, K1, K1), (P, K1), (P, K1) -> (P, K1, K1), differentiable."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iterations):
        u = log_mu - _lse(scores + v[..., None, :], dim=-1)
        v = log_nu - _lse(scores + u[..., :, None], dim=-2)
    return scores + u[..., :, None] + v[..., None, :]


def sinkhorn(scores, log_mu, log_nu, num_iterations: int, use_kernel: bool = True):
    """The reference has no kernel: ``use_kernel`` is accepted and ignored."""
    return sinkhorn_plain(scores, log_mu, log_nu, num_iterations)
