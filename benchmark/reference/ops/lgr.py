"""Local-to-Global Registration (twin of ``rdmnet_tpu/ops/lgr.py``).

Each patch contributes at most K row-side and K column-side correspondences
per top-k slot, so the correspondence set is static (P, 2*K*topk) entries
with zero weight for absent ones. Per-patch Procrustes hypotheses are
verified by inlier count over the whole set, and the best is refined
globally.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from benchmark.reference.config import FineMatchingConfig
from benchmark.reference.ops.geometry import apply_transform
from benchmark.reference.ops.procrustes import weighted_procrustes
from benchmark.reference.ops.select import top_k


class Correspondences(NamedTuple):
    """Flat padded correspondence set (C = P * entries per patch)."""

    ref_points: torch.Tensor   # (C, 3)
    src_points: torch.Tensor   # (C, 3)
    scores: torch.Tensor       # (C,) zero = padding
    patch_ids: torch.Tensor    # (C,) owning patch


def _extract_correspondences(scores, ref_knn_points, src_knn_points, ref_knn_masks,
                             src_knn_masks, corr_valid, cfg: FineMatchingConfig):
    """Top-k rows/columns of the (P, K+1, K+1) exp'd plan, compared with the
    dustbin; union (duplicates zeroed) or intersection (``cfg.mutual``)."""
    p, k1, _ = scores.shape
    k = k1 - 1
    t = cfg.topk
    assert 1 <= t <= k, f"fine_matching.topk={t} out of range [1, {k}]"
    dev = scores.device
    mask_mat = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]   # (P, K, K)
    dust_col = scores[:, :k, k]
    dust_row = scores[:, k, :k]

    if cfg.use_dustbin:
        row_vals, row_idx = top_k(scores[:, :k, :], t)                 # (P, K, t)
        row_keep = (row_idx < k) & (row_vals > dust_col[..., None])
        col_vals, col_idx = top_k(scores[:, :, :k].transpose(1, 2), t)
        col_keep = (col_idx < k) & (col_vals > dust_row[..., None])
    else:
        row_vals, row_idx = top_k(scores[:, :k, :k], t)
        row_keep = row_vals > cfg.confidence_threshold
        col_vals, col_idx = top_k(scores[:, :k, :k].transpose(1, 2), t)
        col_keep = col_vals > cfg.confidence_threshold
    row_j = torch.clamp(row_idx, max=k - 1)
    col_i = torch.clamp(col_idx, max=k - 1)

    pi = torch.arange(p, device=dev)[:, None, None]
    rows_i = torch.arange(k, device=dev)[None, :, None]
    row_keep = row_keep & mask_mat[pi, rows_i, row_j] & corr_valid[:, None, None]
    col_keep = col_keep & mask_mat[pi, col_i, rows_i] & corr_valid[:, None, None]

    ar = torch.arange(k, device=dev)[None, :, None, None]
    if cfg.mutual:
        # row entry (i, j) survives iff column j's selections include row i
        ci_at = col_i[pi, row_j]                                        # (P, K, t, t)
        ck_at = col_keep[pi, row_j]
        member = ((ci_at == ar) & ck_at).any(dim=-1)
        row_keep = row_keep & member
        col_keep = torch.zeros_like(col_keep)
    else:
        # union: drop column entries the row side already selected
        rj_at = row_j[pi, col_i]
        rk_at = row_keep[pi, col_i]
        col_keep = col_keep & ~((rj_at == ar) & rk_at).any(dim=-1)

    zero = torch.zeros((), dtype=scores.dtype, device=dev)
    row_w = torch.where(row_keep, row_vals, zero)
    col_w = torch.where(col_keep, col_vals, zero)

    row_ref = ref_knn_points.repeat_interleave(t, dim=1)                # (P, K*t, 3)
    row_src = torch.gather(src_knn_points, 1,
                           row_j.reshape(p, k * t, 1).long().expand(p, k * t, 3))
    if cfg.mutual:
        ref_pts, src_pts, weights = row_ref, row_src, row_w.reshape(p, k * t)
    else:
        col_ref = torch.gather(ref_knn_points, 1,
                               col_i.reshape(p, k * t, 1).long().expand(p, k * t, 3))
        col_src = src_knn_points.repeat_interleave(t, dim=1)
        ref_pts = torch.cat([row_ref, col_ref], dim=1)
        src_pts = torch.cat([row_src, col_src], dim=1)
        weights = torch.cat([row_w.reshape(p, k * t), col_w.reshape(p, k * t)], dim=1)

    counts = (weights > 0).sum(dim=1)
    c = weights.shape[1]
    corr = Correspondences(
        ref_points=ref_pts.reshape(p * c, 3),
        src_points=src_pts.reshape(p * c, 3),
        scores=weights.reshape(p * c),
        patch_ids=torch.arange(p, dtype=torch.int32, device=dev).repeat_interleave(c),
    )
    return corr, counts


def _inlier_weights(corr: Correspondences, transform, radius):
    res = torch.linalg.norm(corr.ref_points - apply_transform(corr.src_points, transform), dim=-1)
    return corr.scores * (res < radius).to(corr.scores.dtype)


def local_to_global_registration(ref_knn_points, src_knn_points, ref_knn_masks, src_knn_masks,
                                 matching_scores, corr_valid, cfg: FineMatchingConfig,
                                 node_corr_scores: Optional[torch.Tensor] = None,
                                 trace: Optional[dict] = None
                                 ) -> Tuple[Correspondences, torch.Tensor]:
    """Full LGR: returns the flat correspondence set and the (4, 4) transform.
    ``trace``, when given, receives LGR's decisions: ``ver_scores`` (the
    scores ``correspondence_limit`` selects from) and ``ver_index`` (its
    selection, None without one), ``residuals`` (one (M, N) tensor per
    inlier decision: the P + 1 hypotheses, then each refinement's pose),
    ``gate`` (the hypotheses that may be chosen), ``best`` (the chosen one)
    and ``weights`` (those of each fit after it, the last giving the pose)."""
    scores = torch.exp(matching_scores)
    corr, counts = _extract_correspondences(scores, ref_knn_points, src_knn_points,
                                            ref_knn_masks, src_knn_masks, corr_valid, cfg)
    if cfg.use_global_score and node_corr_scores is not None:
        per_entry = node_corr_scores.repeat_interleave(
            corr.scores.shape[0] // node_corr_scores.shape[0])
        corr = corr._replace(scores=corr.scores * per_entry)

    return corr, register(corr, counts, ref_knn_masks.shape[0], cfg, trace)


def register(corr: Correspondences, counts: torch.Tensor, p: int, cfg: FineMatchingConfig,
             trace: Optional[dict] = None) -> torch.Tensor:
    """LGR's pose from a flat correspondence set of ``p`` patches (``counts``:
    each patch's correspondences before any global score): each patch's
    Procrustes hypothesis and the global one verified by inlier count, the
    best refined. ``trace`` as ``local_to_global_registration``'s."""
    cpp = corr.scores.shape[0] // p
    if cfg.correspondence_limit is not None and cfg.correspondence_limit < p * cpp:
        ver_scores, sel = top_k(corr.scores, cfg.correspondence_limit)
        ver = Correspondences(corr.ref_points[sel], corr.src_points[sel], ver_scores,
                              corr.patch_ids[sel])
    else:
        sel = None
        ver = corr

    hyp = weighted_procrustes(corr.src_points.reshape(p, cpp, 3),
                              corr.ref_points.reshape(p, cpp, 3),
                              corr.scores.reshape(p, cpp))                # (P, 4, 4)
    hyp_ok = counts >= cfg.correspondence_threshold
    global_tf = weighted_procrustes(ver.src_points, ver.ref_points, ver.scores)
    all_tfs = torch.cat([hyp, global_tf[None]], dim=0)                     # (P+1, 4, 4)

    aligned = apply_transform(ver.src_points[None].expand(p + 1, -1, -1), all_tfs)
    res = torch.linalg.norm(ver.ref_points[None] - aligned, dim=-1)
    inlier = (res < cfg.acceptance_radius) & (ver.scores > 0)[None]
    inlier_counts = inlier.sum(dim=1)
    gate = torch.cat([hyp_ok, ~hyp_ok.any()[None]])
    inlier_counts = torch.where(gate, inlier_counts, torch.full_like(inlier_counts, -1))
    best = torch.argmax(inlier_counts)  # first maximum, as jnp.argmax
    # a 1-element index: no host read of the 0-d argmax
    cur_scores = ver.scores * torch.index_select(inlier, 0, best[None])[0].to(ver.scores.dtype)
    if trace is not None:
        trace.update(ver_scores=corr.scores, ver_index=sel, residuals=[res], gate=gate,
                     best=best, weights=[cur_scores])
    transform = weighted_procrustes(ver.src_points, ver.ref_points, cur_scores)
    for _ in range(cfg.num_refinement_steps - 1):
        cur_scores = _inlier_weights(ver, transform, cfg.acceptance_radius)
        if trace is not None:
            trace["residuals"].append(torch.linalg.norm(
                ver.ref_points - apply_transform(ver.src_points, transform), dim=-1)[None])
            trace["weights"].append(cur_scores)
        transform = weighted_procrustes(ver.src_points, ver.ref_points, cur_scores)
    return transform
