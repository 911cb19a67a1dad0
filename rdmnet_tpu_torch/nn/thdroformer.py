"""ThDRoFormer — 3D rotary conditional transformer
(twin of ``rdmnet_tpu/nn/thdroformer.py``, dense attention).

Interleaved [rotary self-attention, vanilla cross-attention] layers over the
two clouds, with positional angles from raw xyz by Linear(3 -> hidden/2).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rdmnet_tpu_torch.nn.attention import RotaryTransformerLayer, TransformerLayer


class ThDRoFormer(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        self.embedding = nn.Linear(3, hidden_dim // 2)
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        for layer in range(num_layers):
            setattr(self, f"self_{layer}", RotaryTransformerLayer(hidden_dim, num_heads))
            setattr(self, f"cross_{layer}", TransformerLayer(hidden_dim, num_heads))
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, ref_points, src_points, ref_feats, src_feats,
                ref_valid: Optional[torch.Tensor] = None,
                src_valid: Optional[torch.Tensor] = None):
        ref_pe = self.embedding(ref_points)
        src_pe = self.embedding(src_points)
        ref_x = self.in_proj(ref_feats)
        src_x = self.in_proj(src_feats)
        for layer in range(self.num_layers):
            self_layer = getattr(self, f"self_{layer}")
            ref_x = self_layer(ref_x, ref_x, ref_pe, memory_valid=ref_valid)
            src_x = self_layer(src_x, src_x, src_pe, memory_valid=src_valid)
            cross_layer = getattr(self, f"cross_{layer}")
            # sequential cross: src attends the already-updated ref
            ref_x = cross_layer(ref_x, src_x, memory_valid=src_valid)
            src_x = cross_layer(src_x, ref_x, memory_valid=ref_valid)
        return self.out_proj(ref_x), self.out_proj(src_x)
