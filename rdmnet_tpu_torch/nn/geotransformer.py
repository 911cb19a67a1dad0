"""The GeoTransformer stack (twin of ``rdmnet_tpu/nn/geotransformer.py``),
``coarse_module="geotransformer"``.

* ``GeometricStructureEmbedding``: a sinusoidal embedding of pairwise
  distances (temperature ``sigma_d``) plus a max- or mean-reduced embedding
  of the angles between each pair's vector and each point's vectors to its
  ``angle_k`` nearest neighbours (temperature ``sigma_a``);
* RPE attention: the embedding projected per head and added into the logits
  as q . p.

Pad rows sit at far-away sentinel coordinates, where the distance indices
reach ~1e8 and float32 sines of such arguments differ between libraries;
pad keys are masked before every softmax and pad query rows never reach
matching, so only valid rows carry meaning.

Departure from the JAX package, on purpose: the distance and angle indices
carry no gradient to the points, as upstream GeoTransformer computes them
under ``no_grad``. In the JAX package they do, and on stage 2, whose nodes
are the vote layer's differentiable shifts, the zero-length pair vectors of
the diagonal (``sqrt`` at 0, the norm and ``arctan2`` of a zero cross
product) make every gradient upstream of it NaN.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from rdmnet_tpu_torch.nn.attention import (
    NEG_INF,
    AttentionOutput,
    TransformerLayer,
    _merge_heads,
    _split_heads,
)
from rdmnet_tpu_torch.ops.geometry import pairwise_sq_dist

BIG = 1.0e12


def sinusoidal_embedding(indices: torch.Tensor, d_model: int) -> torch.Tensor:
    """(*,) real-valued indices -> (*, d_model), sin and cos interleaved."""
    half = d_model // 2
    scale = -torch.log(torch.tensor(10000.0, device=indices.device)) / half  # float32
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=indices.device) * scale)
    angles = indices[..., None] * div
    return torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1).reshape(
        indices.shape + (d_model,))


class GeometricStructureEmbedding(nn.Module):
    def __init__(self, hidden_dim: int, sigma_d: float, sigma_a: float, angle_k: int,
                 reduction_a: str = "max"):
        super().__init__()
        self.hidden_dim, self.sigma_d, self.sigma_a = hidden_dim, sigma_d, sigma_a
        self.angle_k, self.reduction_a = angle_k, reduction_a
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        self.proj_a = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, points: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        points = points.detach()  # indices without gradient (module docstring)
        # distances with the JAX package's FMA rounding: the k nearest
        # neighbours below are chosen on them
        sq_raw = pairwise_sq_dist(points, points)
        sq = sq_raw
        if valid is not None:
            sq = torch.where(valid[None, :] & valid[:, None], sq_raw, torch.full_like(sq_raw, BIG))
        d_indices = torch.sqrt(sq_raw) / self.sigma_d

        # the k nearest excluding self; a stable ascending sort breaks ties
        # by lower index, as lax.top_k of -sq does
        k = self.angle_k
        vals, knn_idx = torch.sort(sq, dim=1, stable=True)
        vals, knn_idx = vals[:, 1:k + 1], knn_idx[:, 1:k + 1]                   # (N, k)
        ref_vec = points[knn_idx] - points[:, None, :]                          # (N, k, 3)
        # fewer than k valid neighbours: the slot would point at a pad row's
        # sentinel coordinates; a unit vector keeps its angles bounded
        ref_vec = torch.where((vals < 0.5 * BIG)[..., None], ref_vec,
                              ref_vec.new_tensor([1.0, 0.0, 0.0]))
        anc_vec = points[None, :, :] - points[:, None, :]                       # (N, N, 3)
        ref_b = ref_vec[:, None, :, :].expand(-1, anc_vec.shape[1], -1, -1)
        anc_b = anc_vec[:, :, None, :].expand_as(ref_b)
        sin_v = torch.linalg.norm(torch.linalg.cross(ref_b, anc_b, dim=-1), dim=-1)  # (N, N, k)
        cos_v = (ref_b * anc_b).sum(-1)
        a_indices = torch.atan2(sin_v, cos_v) * (180.0 / (self.sigma_a * math.pi))

        d_emb = self.proj_d(sinusoidal_embedding(d_indices, self.hidden_dim))
        a_emb = self.proj_a(sinusoidal_embedding(a_indices, self.hidden_dim))
        a_emb = a_emb.amax(dim=2) if self.reduction_a == "max" else a_emb.mean(dim=2)
        return d_emb + a_emb                                                    # (N, N, C)


class RPEMultiHeadAttention(nn.Module):
    """Attention with relative positional logits q . p."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.proj_p = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, embed_qk, kv_valid=None):
        h = self.num_heads
        q = _split_heads(self.proj_q(input_q), h)
        k = _split_heads(self.proj_k(input_k), h)
        v = _split_heads(self.proj_v(input_v), h)
        n, m, c = embed_qk.shape
        p = self.proj_p(embed_qk).reshape(n, m, h, c // h).permute(2, 0, 1, 3)  # (h, N, M, d)
        qp = (q[:, :, None, :] @ p.transpose(-1, -2))[:, :, 0, :]              # (h, N, M)
        scores = (q @ k.transpose(-1, -2) + qp) / math.sqrt(q.shape[-1])
        if kv_valid is not None:
            scores = torch.where(kv_valid[None, None, :], scores, torch.full_like(scores, NEG_INF))
        return _merge_heads(torch.softmax(scores, dim=-1) @ v)


class RPETransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention = RPEMultiHeadAttention(d_model, num_heads)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, embed_qk, memory_valid=None):
        hidden = self.attention(input_states, memory_states, memory_states, embed_qk,
                                kv_valid=memory_valid)
        return self.output(self.norm(self.linear(hidden) + input_states))


class GeometricTransformer(nn.Module):
    """Interleaved RPE-self / vanilla-cross blocks with geometric structure
    embeddings. Layers are named by block position (``self_0``,
    ``cross_1``, ...), as the flax module names them."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 blocks: Sequence[str], sigma_d: float, sigma_a: float, angle_k: int,
                 reduction_a: str = "max"):
        super().__init__()
        self.embedding = GeometricStructureEmbedding(hidden_dim, sigma_d, sigma_a, angle_k,
                                                     reduction_a)
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        self.blocks = list(blocks)
        for i, block in enumerate(self.blocks):
            if block == "self":
                setattr(self, f"self_{i}", RPETransformerLayer(hidden_dim, num_heads))
            elif block == "cross":
                setattr(self, f"cross_{i}", TransformerLayer(hidden_dim, num_heads))
            else:
                raise ValueError(f"unknown block type {block}")
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_valid=None,
                src_valid=None):
        ref_emb = self.embedding(ref_points, ref_valid)
        src_emb = self.embedding(src_points, src_valid)
        ref_x, src_x = self.in_proj(ref_feats), self.in_proj(src_feats)
        for i, block in enumerate(self.blocks):
            layer = getattr(self, f"{block}_{i}")
            if block == "self":
                ref_x = layer(ref_x, ref_x, ref_emb, memory_valid=ref_valid)
                src_x = layer(src_x, src_x, src_emb, memory_valid=src_valid)
            else:
                ref_x = layer(ref_x, src_x, memory_valid=src_valid)
                src_x = layer(src_x, ref_x, memory_valid=ref_valid)
        return self.out_proj(ref_x), self.out_proj(src_x)
