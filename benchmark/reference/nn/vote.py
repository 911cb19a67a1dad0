"""Vote/offset layer (twin of ``rdmnet_tpu/nn/vote.py``).

A shared MLP over node features regresses per-node xyz offsets (clamped to
+-max_translate_range) and feature offsets (residual + LayerNorm). Works on
any leading batch shape, e.g. the stacked (2, M, C) pair.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from benchmark.reference.config import VoteConfig


class VoteLayer(nn.Module):
    def __init__(self, cfg: VoteConfig, feat_dim: int):
        super().__init__()
        self.num_mlps = len(cfg.mlps)
        width_in = feat_dim
        for i, width in enumerate(cfg.mlps):
            setattr(self, f"mlp_{i}", nn.Linear(width_in, width))
            setattr(self, f"mlp_norm_{i}", nn.LayerNorm(width, eps=1e-5))
            width_in = width
        self.ctr_reg = nn.Linear(width_in, 3 + feat_dim)
        self.out_norm = nn.LayerNorm(feat_dim, eps=1e-5)
        self.register_buffer("limit", torch.tensor(cfg.max_translate_range, dtype=torch.float32),
                             persistent=False)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = feats
        for i in range(self.num_mlps):
            x = F.relu(getattr(self, f"mlp_norm_{i}")(getattr(self, f"mlp_{i}")(x)))
        offsets = self.ctr_reg(x)
        ctr = torch.maximum(torch.minimum(offsets[..., :3], self.limit), -self.limit)
        return xyz + ctr, self.out_norm(feats + offsets[..., 3:])
