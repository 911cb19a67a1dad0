"""Conditional transformer variants (twin of ``rdmnet_tpu/nn/transformers.py``).

* ``VanillaConditionalTransformer``: plain self/cross blocks;
* ``PEConditionalTransformer``: absolute positional embeddings projected by
  one shared ``proj_p`` and added to q and k (not v) in each self block;
* ``LRPEConditionalTransformer``: learnable relative positional embedding,
  a bank of P embeddings scored against q (q . e_p), gathered by integer
  pair-distance indices and added to the attention logits.

Layers are named ``self_{i}`` / ``cross_{i}``, counted per block type, as
the flax modules are, so ``utils/convert.params_from_jax`` stays a tree walk.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn

from benchmark.reference.nn.attention import (
    NEG_INF,
    AttentionOutput,
    TransformerLayer,
    _merge_heads,
    _split_heads,
    attend,
)


class LearnablePositionalEmbedding(nn.Module):
    """Truncated learnable embedding table + LayerNorm."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embeddings = nn.Parameter(torch.randn(num_embeddings, embedding_dim))
        self.norm = nn.LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, emb_indices: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(emb_indices, max=self.num_embeddings - 1).long()
        return self.norm(self.embeddings[idx])


class LRPEMultiHeadAttention(nn.Module):
    """logits = (q . k + gather_p(q . e_p)) / sqrt(d)."""

    def __init__(self, d_model: int, num_heads: int, num_embeddings: int):
        super().__init__()
        self.num_heads, self.num_embeddings = num_heads, num_embeddings
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.embedding = LearnablePositionalEmbedding(num_embeddings, d_model)

    def forward(self, input_q, input_k, input_v, emb_indices_qk, kv_valid=None):
        h, p = self.num_heads, self.num_embeddings
        q = _split_heads(self.proj_q(input_q), h)
        k = _split_heads(self.proj_k(input_k), h)
        v = _split_heads(self.proj_v(input_v), h)
        d = q.shape[-1]
        bank = self.embedding(torch.arange(p, device=q.device))
        bank = bank.reshape(p, h, d).transpose(0, 1)                 # (h, P, d)
        scores_p = q @ bank.transpose(-1, -2)                        # (h, N, P)
        idx = torch.clamp(emb_indices_qk, max=p - 1).long()
        scores_rpe = torch.gather(scores_p, 2, idx[None].expand(h, -1, -1))
        scores = (q @ k.transpose(-1, -2) + scores_rpe) / math.sqrt(d)
        if kv_valid is not None:
            scores = torch.where(kv_valid[None, None, :], scores, torch.full_like(scores, NEG_INF))
        return _merge_heads(torch.softmax(scores, dim=-1) @ v)


class LRPETransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_embeddings: int):
        super().__init__()
        self.attention = LRPEMultiHeadAttention(d_model, num_heads, num_embeddings)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, emb_indices, memory_valid=None):
        hidden = self.attention(input_states, memory_states, memory_states, emb_indices,
                                kv_valid=memory_valid)
        return self.output(self.norm(self.linear(hidden) + input_states))


class PEMultiHeadAttention(nn.Module):
    """q = proj_q(f_q) + proj_p(e_q), k = proj_k(f_k) + proj_p(e_k) with one
    shared proj_p; v = proj_v(f_k): the embedding never reaches v."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.proj_p = nn.Linear(d_model, d_model)
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, embed_q, embed_k, kv_valid=None):
        h = self.num_heads
        q = _split_heads(self.proj_q(input_q) + self.proj_p(embed_q), h)
        k = _split_heads(self.proj_k(input_k) + self.proj_p(embed_k), h)
        v = _split_heads(self.proj_v(input_v), h)
        return _merge_heads(attend(q, k, v, kv_valid))


class PETransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention = PEMultiHeadAttention(d_model, num_heads)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, input_emb, memory_emb, memory_valid=None):
        hidden = self.attention(input_states, memory_states, memory_states, input_emb,
                                memory_emb, kv_valid=memory_valid)
        return self.output(self.norm(self.linear(hidden) + input_states))


def _pair_block_names(blocks: Sequence[str]) -> List[str]:
    """Per-type layer names: ("self", "cross", "self") -> self_0, cross_0, self_1."""
    counts: Dict[str, int] = {}
    names = []
    for block in blocks:
        names.append(f"{block}_{counts.get(block, 0)}")
        counts[block] = counts.get(block, 0) + 1
    return names


def _build_blocks(module: nn.Module, blocks: Sequence[str], self_layer, cross_layer) -> None:
    module.blocks = list(zip(blocks, _pair_block_names(blocks)))
    for block, name in module.blocks:
        setattr(module, name, self_layer() if block == "self" else cross_layer())


def _run_blocks(module: nn.Module, ref_feats, src_feats, ref_valid, src_valid, self_block):
    """Interleaved blocks over the two clouds: ``self_block(layer, side,
    feats, valid)`` for self blocks (side 0 = ref, 1 = src); cross blocks are
    vanilla and sequential (src attends the already-updated ref)."""
    for block, name in module.blocks:
        layer = getattr(module, name)
        if block == "self":
            ref_feats = self_block(layer, 0, ref_feats, ref_valid)
            src_feats = self_block(layer, 1, src_feats, src_valid)
        else:
            ref_feats = layer(ref_feats, src_feats, memory_valid=src_valid)
            src_feats = layer(src_feats, ref_feats, memory_valid=ref_valid)
    return ref_feats, src_feats


class VanillaConditionalTransformer(nn.Module):
    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int):
        super().__init__()
        layer = lambda: TransformerLayer(d_model, num_heads)  # noqa: E731
        _build_blocks(self, blocks, layer, layer)

    def forward(self, ref_feats, src_feats, ref_valid=None, src_valid=None):
        return _run_blocks(self, ref_feats, src_feats, ref_valid, src_valid,
                           lambda layer, _, x, valid: layer(x, x, memory_valid=valid))


class PEConditionalTransformer(nn.Module):
    """Self blocks are ``PETransformerLayer``s fed the positional embeddings."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int):
        super().__init__()
        _build_blocks(self, blocks, lambda: PETransformerLayer(d_model, num_heads),
                      lambda: TransformerLayer(d_model, num_heads))

    def forward(self, ref_feats, src_feats, ref_emb, src_emb, ref_valid=None, src_valid=None):
        embs = (ref_emb, src_emb)
        return _run_blocks(
            self, ref_feats, src_feats, ref_valid, src_valid,
            lambda layer, side, x, valid: layer(x, x, embs[side], embs[side], memory_valid=valid))


class LRPEConditionalTransformer(nn.Module):
    """Self blocks take learnable relative positional logits over integer
    pair-distance indices ((N, N) per cloud)."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int,
                 num_embeddings: int = 64):
        super().__init__()
        _build_blocks(self, blocks,
                      lambda: LRPETransformerLayer(d_model, num_heads, num_embeddings),
                      lambda: TransformerLayer(d_model, num_heads))

    def forward(self, ref_feats, src_feats, ref_emb_indices, src_emb_indices, ref_valid=None,
                src_valid=None):
        idx = (ref_emb_indices, src_emb_indices)
        return _run_blocks(self, ref_feats, src_feats, ref_valid, src_valid,
                           lambda layer, side, x, valid: layer(x, x, idx[side],
                                                               memory_valid=valid))
