"""Coarse (superpoint) matching (twin of ``rdmnet_tpu/nn/matching.py``,
inference branch)."""

from __future__ import annotations

from typing import Tuple

import torch

from rdmnet_tpu_torch.ops.geometry import pairwise_sq_dist
from rdmnet_tpu_torch.ops.select import top_k

NEG = -1.0e9


def superpoint_matching(ref_feats: torch.Tensor, src_feats: torch.Tensor,
                        ref_masks: torch.Tensor, src_masks: torch.Tensor,
                        num_correspondences: int, dual_normalization: bool = True
                        ) -> Tuple[torch.Tensor, ...]:
    """Top-k superpoint correspondences by dual-normalised similarity of
    L2-normalised node features (M, C), (N, C) with masks (M,), (N,).

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
    flat = torch.where(pair_valid, scores, torch.full_like(scores, NEG)).reshape(-1)
    corr_scores, corr_indices = top_k(flat, num_correspondences)
    n = src_feats.shape[0]
    ref_corr = torch.div(corr_indices, n, rounding_mode="floor").to(torch.int32)
    src_corr = (corr_indices % n).to(torch.int32)
    corr_valid = corr_scores > NEG / 2
    corr_scores = torch.where(corr_valid, corr_scores, torch.zeros_like(corr_scores))
    return ref_corr, src_corr, corr_scores, corr_valid
