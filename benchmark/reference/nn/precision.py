"""The compute dtype of the backbone and ThDRoFormer (``Config.compute_dtype``).

The JAX package keeps float32 master weights and casts them at use: dense
layers and KPConv's products run in the compute dtype, while norm
statistics, softmax logits, the rotary rotation, geometry, Sinkhorn and the
pose stay float32 (``rdmnet_tpu/config.py:369-371``). Under ``"float32"``
every helper here is the plain float32 operation it replaces.

Two kinds of product:
* ``Dense`` is flax's ``Dense(dtype=bf16)``: input, weight and bias cast to
  bfloat16, the product rounded to bfloat16, then the bias added in
  bfloat16 (two roundings, as flax adds the bias after ``dot_general``);
* ``matmul_f32`` is XLA's ``preferred_element_type=float32``: bfloat16
  operands, a float32 result. Products of two bfloat16 values are exact in
  float32, so only the summation order differs between devices. On the card
  the forward is one bf16 GEMM with a float32 output (``torch.mm``/``bmm``
  with ``out_dtype``; the tensor cores), whose backward PyTorch does not
  implement: ``_MatmulF32`` gives it the gradients of the float32 product of
  the widened operands, rounded to the operands' dtype, which is what the
  CPU's route (operands widened to float32, then multiplied) gets from
  autograd.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of ``Config.compute_dtype``; raises on any other name."""
    if name not in DTYPES:
        raise ValueError(f"compute_dtype {name!r}: expected one of {sorted(DTYPES)}")
    return DTYPES[name]


class _MatmulF32(torch.autograd.Function):
    """The card's low-precision GEMM with a float32 output, differentiable."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (grad @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().transpose(-1, -2) @ grad).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) with a float32 result."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)`` then a cast to ``dtype``."""
    return norm(x.float()).to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``; the parameters stay float32
    (their names and the state dict are ``nn.Linear``'s)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)
