"""ThDRoFormer — 3D rotary conditional transformer, and the absolute-PE
variant (twin of ``rdmnet_tpu/nn/thdroformer.py``).

Interleaved [rotary self-attention, vanilla cross-attention] layers over the
two clouds, with positional angles from raw xyz by Linear(3 -> hidden/2).
``k`` (one fraction per layer) makes the self-attention sparse: each query
keeps its top ``int(cap * frac)`` keys, of which the first
``floor(valid * frac)`` carry weight. ThDRoFormer computes in ``dtype``
(``nn/precision.py``) from ``in_proj`` to ``out_proj`` and returns float32;
the positional embedding stays float32. The APE variant, like the JAX one,
takes no dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from benchmark.reference.nn.attention import RotaryTransformerLayer, TransformerLayer
from benchmark.reference.nn.precision import Dense
from benchmark.reference.nn.transformers import PEConditionalTransformer


def topk_schedule(cap: int, frac: float) -> int:
    """The static rank bound of a sparse layer at capacity ``cap``."""
    return max(1, min(cap, int(cap * frac)))


def dyn_count(valid: Optional[torch.Tensor], frac: float, kmax: int) -> Optional[torch.Tensor]:
    """``floor(valid count * frac)`` in float32, clipped to [1, kmax] (0-d)."""
    if valid is None:
        return None
    count = torch.floor(valid.sum().to(torch.float32) * frac)
    return torch.clamp(count.to(torch.int32), 1, kmax)


class ThDRoFormer(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 num_layers: int, k: Optional[Sequence[float]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.k = None if k is None else tuple(k)
        self.embedding = nn.Linear(3, hidden_dim // 2)
        self.in_proj = Dense(input_dim, hidden_dim, dtype=dtype)
        for layer in range(num_layers):
            setattr(self, f"self_{layer}",
                    RotaryTransformerLayer(hidden_dim, num_heads, dtype=dtype))
            setattr(self, f"cross_{layer}", TransformerLayer(hidden_dim, num_heads, dtype=dtype))
        self.out_proj = Dense(hidden_dim, output_dim, dtype=dtype)

    def forward(self, ref_points, src_points, ref_feats, src_feats,
                ref_valid: Optional[torch.Tensor] = None,
                src_valid: Optional[torch.Tensor] = None):
        ref_pe = self.embedding(ref_points)
        src_pe = self.embedding(src_points)
        ref_x = self.in_proj(ref_feats)
        src_x = self.in_proj(src_feats)
        for layer in range(self.num_layers):
            topk = ref_kc = src_kc = None
            if self.k is not None:
                # the rank bound from the padded capacity, as the JAX package
                # takes it from the static shape
                frac = self.k[layer]
                topk = topk_schedule(ref_x.shape[0], frac)
                ref_kc = dyn_count(ref_valid, frac, topk)
                src_kc = dyn_count(src_valid, frac, topk)
            self_layer = getattr(self, f"self_{layer}")
            ref_x = self_layer(ref_x, ref_x, ref_pe, memory_valid=ref_valid, topk=topk,
                               topk_count=ref_kc)
            src_x = self_layer(src_x, src_x, src_pe, memory_valid=src_valid, topk=topk,
                               topk_count=src_kc)
            cross_layer = getattr(self, f"cross_{layer}")
            # sequential cross: src attends the already-updated ref
            ref_x = cross_layer(ref_x, src_x, memory_valid=src_valid)
            src_x = cross_layer(src_x, ref_x, memory_valid=ref_valid)
        return self.out_proj(ref_x).float(), self.out_proj(src_x).float()


class APETransformer(nn.Module):
    """Absolute positional embedding: Linear(3 -> hidden) of raw xyz, fed to
    a ``PEConditionalTransformer`` (the embedding enters q and k only)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 num_layers: int):
        super().__init__()
        self.embedding = nn.Linear(3, hidden_dim)
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        self.transformer = PEConditionalTransformer(("self", "cross") * num_layers, hidden_dim,
                                                    num_heads)
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_valid=None,
                src_valid=None):
        ref_x, src_x = self.transformer(self.in_proj(ref_feats), self.in_proj(src_feats),
                                        self.embedding(ref_points), self.embedding(src_points),
                                        ref_valid=ref_valid, src_valid=src_valid)
        return self.out_proj(ref_x), self.out_proj(src_x)
