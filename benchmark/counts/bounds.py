"""The least time the card could take for the port's kernels on one pair,
frozen here from the port's own definitions (its kernel probe and chip
checks):

* a radius-kNN search: the longer of its inputs and its table moved once at
  the memory rate and 9 float32 operations (3 FMA, a subtract, an add, a
  max) for each pair of a valid query and a valid row of a 32-row chunk of
  its window whose bounding box the radius reaches, at the float32 rate;
* the log-domain Sinkhorn: each half-step's exp of every entry on the SFUs
  (132 SMs x 16 a clock at 1980 MHz)."""

from __future__ import annotations

from typing import Sequence

from benchmark.counts.peaks import (F32_FLOPS, HBM_BYTES_PER_S, MAX_CLOCK_HZ, NUM_SMS,
                                    SFU_PER_SM_CLK)

KNN_OPS_PER_PAIR = 9


def knn_work(q, s, cnt, qcnt, radius_sq: float, win=None, chunk=0, band=0):
    """(window pairs, reached pairs) of a search over its valid queries."""
    import torch

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
        n_rows = ok.view(-1, nb, 32).sum(-1)
        nvq = int(qcnt[b])
        for q0 in range(0, nvq, 2048):
            qq = q[b, q0:min(q0 + 2048, nvq)]
            wi = (torch.arange(q0, q0 + qq.shape[0], device=q.device) // chunk
                  if win is not None else torch.zeros(qq.shape[0], dtype=torch.long,
                                                      device=q.device))
            gap = (torch.clamp_min(lo[wi] - qq[:, None], 0)
                   + torch.clamp_min(qq[:, None] - hi[wi], 0))
            near = (gap * gap).sum(-1) <= radius_sq
            window += int(n_rows[wi].sum())
            reached += int((n_rows[wi] * near).sum())
    return window, reached


def knn_bound_ms(q, s, cnt, qcnt, radius_sq: float, k: int, win=None, chunk=0, band=0) -> float:
    _, reached = knn_work(q, s, cnt, qcnt, radius_sq, win, chunk, band)
    bsz, nq, _ = q.shape
    nbytes = bsz * (nq * 3 * 4 + s.shape[1] * 3 * 4 + nq * k * 4)
    return max(nbytes / HBM_BYTES_PER_S, reached * KNN_OPS_PER_PAIR / F32_FLOPS) * 1e3


def knn_pair_bound_ms(cfg, pts: Sequence, cnts: Sequence) -> float:
    """The 12 searches of one pair's graph build (both clouds in each)."""
    from benchmark.reference.graph.pyramid import search_plan
    from benchmark.reference.kernels import radius_sq
    from benchmark.reference.ops.radius_search import band_windows

    total = 0.0
    for sp in search_plan(cfg.pyramid):
        q, s = pts[sp.q_lvl].contiguous(), pts[sp.s_lvl].contiguous()
        kw = {}
        if sp.band is not None:
            win, _ = band_windows(q, s, cnts[sp.q_lvl], sp.radius, sp.cell, sp.band, sp.chunk)
            kw = dict(win=win, chunk=sp.chunk, band=sp.band)
        total += knn_bound_ms(q, s, cnts[sp.s_lvl], cnts[sp.q_lvl], radius_sq(sp.radius), sp.k,
                              **kw)
    return total


def sinkhorn_bound_ms(patches: int, k1: int, iterations: int) -> float:
    exps = 2 * iterations * patches * k1 * k1
    return exps / (NUM_SMS * SFU_PER_SM_CLK * MAX_CLOCK_HZ) * 1e3


def sinkhorn_pair_bound_ms(cfg) -> float:
    """One served pair: every matched patch pair, its points plus the dustbin."""
    return sinkhorn_bound_ms(cfg.coarse_matching.num_correspondences,
                             cfg.model.num_points_in_patch + 1, cfg.model.num_sinkhorn_iterations)


