"""Attention building blocks (twin of ``rdmnet_tpu/nn/attention.py``).

Masked, unbatched (N, C) attention for padded clouds. ``valid`` masks are
True for real entries; invalid keys are set to -1e9 (not -inf) before the
softmax, as in the JAX package, so a fully masked row stays finite. Dense
attention only (the inference default).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

NEG_INF = -1.0e9


def rotary_rotate(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent feature pairs (x[2i], x[2i+1]) of x (..., D) by
    theta (..., D/2)."""
    xp = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
    cos, sin = torch.cos(theta), torch.sin(theta)
    x0, x1 = xp[..., 0], xp[..., 1]
    rot = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return rot.reshape(x.shape)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    n, c = x.shape
    return x.reshape(n, num_heads, c // num_heads).transpose(0, 1)  # (H, N, d)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    h, n, d = x.shape
    return x.transpose(0, 1).reshape(n, h * d)


def attend(q, k, v, kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked softmax attention: (H, N, d), (H, M, d), (H, M, d) -> (H, N, d)."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if kv_valid is not None:
        scores = torch.where(kv_valid[None, None, :], scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1) @ v


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, kv_valid=None):
        h = self.num_heads
        q = _split_heads(self.proj_q(input_q), h)
        k = _split_heads(self.proj_k(input_k), h)
        v = _split_heads(self.proj_v(input_v), h)
        return _merge_heads(attend(q, k, v, kv_valid))


class RotaryMultiHeadAttention(MultiHeadAttention):
    """MHA with 3D rotary rotation of q and k: per-head angles
    sigmoid(pos_emb) * 2 pi, one per adjacent feature pair."""

    def forward(self, input_q, input_k, input_v, pos_emb_q, pos_emb_k, kv_valid=None):
        h = self.num_heads

        def theta(pe):
            n = pe.shape[0]
            return torch.sigmoid(pe.reshape(n, h, -1).transpose(0, 1)) * (2.0 * math.pi)

        q = rotary_rotate(_split_heads(self.proj_q(input_q), h), theta(pos_emb_q))
        k = rotary_rotate(_split_heads(self.proj_k(input_k), h), theta(pos_emb_k))
        v = _split_heads(self.proj_v(input_v), h)
        return _merge_heads(attend(q, k, v, kv_valid))


class AttentionOutput(nn.Module):
    """Post-norm FFN (expand x2)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.expand = nn.Linear(d_model, d_model * 2)
        self.squeeze = nn.Linear(d_model * 2, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


class TransformerLayer(nn.Module):
    """Vanilla (cross) attention layer + FFN, post-norm residual."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention = MultiHeadAttention(d_model, num_heads)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, memory_valid=None):
        hidden = self.attention(input_states, memory_states, memory_states, kv_valid=memory_valid)
        x = self.norm(self.linear(hidden) + input_states)
        return self.output(x)


class RotaryTransformerLayer(nn.Module):
    """Rotary self-attention layer + FFN."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention = RotaryMultiHeadAttention(d_model, num_heads)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, pos_emb, memory_valid=None):
        hidden = self.attention(input_states, memory_states, memory_states, pos_emb, pos_emb,
                                kv_valid=memory_valid)
        x = self.norm(self.linear(hidden) + input_states)
        return self.output(x)
