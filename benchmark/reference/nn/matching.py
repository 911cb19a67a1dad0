"""Coarse (superpoint) matching and training target sampling
(twin of ``rdmnet_tpu/nn/matching.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.ops.geometry import pairwise_sq_dist
from benchmark.reference.ops.select import top_k

NEG = -1.0e9


def superpoint_matching(ref_feats: torch.Tensor, src_feats: torch.Tensor,
                        ref_masks: torch.Tensor, src_masks: torch.Tensor,
                        num_correspondences: int, dual_normalization: bool = True,
                        ref_n2p_scores: Optional[torch.Tensor] = None,
                        src_n2p_scores: Optional[torch.Tensor] = None,
                        n2p_score_threshold: float = 0.1) -> Tuple[torch.Tensor, ...]:
    """Top-k superpoint correspondences by dual-normalised similarity of
    L2-normalised node features (M, C), (N, C) with masks (M,), (N,).

    ``ref_n2p_scores`` (M,) and ``src_n2p_scores`` (N,), when given, gate the
    scores: a pair scores 0 unless both nodes' overlap scores exceed
    ``n2p_score_threshold`` (the model's call leaves the gate off).

    Returns (ref_corr_indices int32, src_corr_indices int32, corr_scores,
    corr_valid), each (num_correspondences,). Invalid pairs rank last.
    """
    scores = torch.exp(-pairwise_sq_dist(ref_feats, src_feats, normalized=True))
    pair_valid = ref_masks[:, None] & src_masks[None, :]
    scores = torch.where(pair_valid, scores, torch.zeros_like(scores))
    if dual_normalization:
        ref_norm = scores / (scores.sum(dim=1, keepdim=True) + 1e-12)
        src_norm = scores / (scores.sum(dim=0, keepdim=True) + 1e-12)
        scores = ref_norm * src_norm
    if ref_n2p_scores is not None:
        gate = ((ref_n2p_scores > n2p_score_threshold)[:, None]
                & (src_n2p_scores > n2p_score_threshold)[None, :])
        scores = torch.where(gate, scores, torch.zeros_like(scores))
    flat = torch.where(pair_valid, scores, torch.full_like(scores, NEG)).reshape(-1)
    corr_scores, corr_indices = top_k(flat, num_correspondences)
    n = src_feats.shape[0]
    ref_corr = torch.div(corr_indices, n, rounding_mode="floor").to(torch.int32)
    src_corr = (corr_indices % n).to(torch.int32)
    corr_valid = corr_scores > NEG / 2
    corr_scores = torch.where(corr_valid, corr_scores, torch.zeros_like(corr_scores))
    return ref_corr, src_corr, corr_scores, corr_valid


def superpoint_target_sample(gt_overlaps: torch.Tensor, num_targets: int,
                             overlap_threshold: float, generator: torch.Generator
                             ) -> Tuple[torch.Tensor, ...]:
    """Up to ``num_targets`` ground-truth node pairs with overlap above the
    threshold, drawn uniformly without replacement: uniform random keys from
    ``generator`` (on the overlaps' device) on the eligible pairs, then an
    exact top-k. The JAX package takes an ``approx_max_k`` there only to dodge
    a TPU crash; its random stream differs from torch's, so the two draw the
    same set only when every eligible pair fits.

    Returns (ref_indices int32, src_indices int32, overlaps, valid), each
    (num_targets,)."""
    m, n = gt_overlaps.shape
    eligible = (gt_overlaps > overlap_threshold).reshape(-1)
    noise = torch.rand(m * n, generator=generator, device=gt_overlaps.device)
    rank = torch.where(eligible, noise, torch.full_like(noise, NEG))
    top_vals, idx = top_k(rank, num_targets)
    valid = top_vals > NEG / 2
    ref_indices = torch.div(idx, n, rounding_mode="floor").to(torch.int32)
    src_indices = (idx % n).to(torch.int32)
    overlaps = torch.where(valid, gt_overlaps.reshape(-1)[idx], torch.zeros_like(top_vals))
    return ref_indices, src_indices, overlaps, valid
