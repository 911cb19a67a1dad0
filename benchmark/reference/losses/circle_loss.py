"""Weighted circle loss over a feature-distance matrix
(twin of ``rdmnet_tpu/losses/circle_loss.py``).

Padded pairs drop out of the logsumexp entirely (a -1e9 argument); valid
pairs that are neither positive nor negative keep the reference's exp(0) = 1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference.ops.geometry import masked_mean

NEG_INF = -1.0e9


def weighted_circle_loss(pos_masks: torch.Tensor, neg_masks: torch.Tensor,
                         feat_dists: torch.Tensor, pos_margin: float, neg_margin: float,
                         pos_optimal: float, neg_optimal: float, log_scale: float,
                         pair_valid: Optional[torch.Tensor] = None,
                         pos_scales: Optional[torch.Tensor] = None,
                         neg_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masks and distances (M, N) -> scalar loss. The pair weights carry no
    gradient (``.detach()``, the JAX package's ``stop_gradient``)."""
    if pair_valid is None:
        pair_valid = torch.ones_like(pos_masks)
    pos_masks = pos_masks & pair_valid
    neg_masks = neg_masks & pair_valid
    row_masks = pos_masks.any(dim=-1) & neg_masks.any(dim=-1)
    col_masks = pos_masks.any(dim=-2) & neg_masks.any(dim=-2)

    pos_weights = feat_dists - 1e5 * (~pos_masks).to(feat_dists.dtype)
    pos_weights = torch.clamp_min(pos_weights - pos_optimal, 0.0)
    if pos_scales is not None:
        pos_weights = pos_weights * pos_scales
    pos_weights = pos_weights.detach()

    neg_weights = feat_dists + 1e5 * (~neg_masks).to(feat_dists.dtype)
    neg_weights = torch.clamp_min(neg_optimal - neg_weights, 0.0)
    if neg_scales is not None:
        neg_weights = neg_weights * neg_scales
    neg_weights = neg_weights.detach()

    pos_arg = log_scale * (feat_dists - pos_margin) * pos_weights
    neg_arg = log_scale * (neg_margin - feat_dists) * neg_weights
    pos_arg = torch.where(pair_valid, pos_arg, torch.full_like(pos_arg, NEG_INF))
    neg_arg = torch.where(pair_valid, neg_arg, torch.full_like(neg_arg, NEG_INF))

    loss_row = F.softplus(torch.logsumexp(pos_arg, dim=-1) + torch.logsumexp(neg_arg, dim=-1))
    loss_col = F.softplus(torch.logsumexp(pos_arg, dim=-2) + torch.logsumexp(neg_arg, dim=-2))
    return 0.5 * (masked_mean(loss_row / log_scale, row_masks)
                  + masked_mean(loss_col / log_scale, col_masks))
