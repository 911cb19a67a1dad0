"""Gradient of the sentinel gathers: CUDA kernel wrapper and its plain
PyTorch version.

Kernel: ``csrc/gather_grad.cu``. It replaces no TPU kernel: the JAX package
gathers with ``jnp.take(x, idx, axis=0, mode="fill")``
(``rdmnet_tpu/ops/geometry.py:44-56``), whose gradient XLA computes as a
scatter-add without Pallas. ``ops/geometry.take_padded`` runs it under
autograd as the backward of every KPConv neighbour gather, maxpool gather,
nearest upsampling and patch gather of the train step.

Both versions compute, for every source row ``n < N``, the sum of the
gradient rows of the positions ``p`` with ``idx[p] == n``, added in
increasing ``p`` from +0 in float32 (float64 for float64 gradients) and
rounded once to the gradient's dtype; a position whose index is not in
``[0, N)`` is a sentinel and is never read, and a row nothing references is
0. The plain version is ``index_add_`` in position order (sequential on the
CPU) with the sentinels sent to a dropped extra row; the kernel (a stable
sort of the indices with their positions, then each row's positions summed
in order) is bit-equal to it and deterministic.

What bounds the kernel is bytes: the non-sentinel gradient rows read once
and ``N * C`` written, beside which the indices (4 bytes an entry, C times
fewer) weigh little. PyTorch's embedding backward, which this replaces on
the card, sums each index's run serially, the sentinel's too (40-80% of a
train step's table), and drops that sum at the write; the kernel never
visits the sentinel's run and reads each gathered row once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rdmnet_tpu_torch.ops.kernels._build import check, launch, load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


def gather_grad_plain(grad: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version: grad (P, C) float, idx (P,) int -> (n, C) in
    grad's dtype. Sentinel positions are summed into row ``n``, which is
    dropped; the others are added in position order into float32 zeros
    (float64 for float64), then rounded once."""
    acc = torch.float64 if grad.dtype == torch.float64 else torch.float32
    rows = torch.where((idx >= 0) & (idx < n), idx.long(), n)
    out = torch.zeros((n + 1,) + tuple(grad.shape[1:]), dtype=acc, device=grad.device)
    out.index_add_(0, rows, grad.to(acc))
    return out[:n].to(grad.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load_library("gather_grad").gather_grad_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gather_grad_cuda(grad: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the tensors' card (one
    launch per call: the keys, the sort, the offsets and the sums). grad
    (P, C) contiguous float32 or bfloat16, idx (P,) contiguous int32, on one
    card -> (n, C) in grad's dtype. ``launches`` counts every launch;
    ``path_launches`` splits them into 16-byte loads ("vector", C a multiple
    of 4 float32 or 8 bfloat16 elements) and one element a load ("scalar")."""
    if not grad.is_cuda or grad.dtype not in DTYPES or not grad.is_contiguous():
        raise ValueError("gather_grad_cuda: grad must be a contiguous CUDA float32 or bfloat16 "
                         "tensor")
    if not idx.is_cuda or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("gather_grad_cuda: idx must be a contiguous CUDA int32 tensor")
    if idx.device != grad.device:
        raise ValueError("gather_grad_cuda: grad and idx must lie on one card")
    if grad.dim() != 2 or idx.shape != grad.shape[:1] or grad.shape[1] < 1:
        raise ValueError(f"gather_grad_cuda: expected grad (P, C) and idx (P,), got "
                         f"{tuple(grad.shape)} and {tuple(idx.shape)}")
    p, c = grad.shape
    if p >= 2 ** 31 or n >= 2 ** 31 - 1:
        raise ValueError("gather_grad_cuda: P and N must fit 31 bits")
    per = 16 // grad.element_size()
    vec = int(c % per == 0 and grad.data_ptr() % 16 == 0)
    out = torch.empty((n, c), dtype=grad.dtype, device=grad.device)
    args = [grad.data_ptr(), idx.data_ptr(), p, n, c, DTYPES[grad.dtype], vec, out.data_ptr()]
    size = ctypes.c_size_t(0)
    check(launch(_launcher(), grad.device, *args, None, ctypes.byref(size)), "gather_grad")
    workspace = torch.empty(size.value, dtype=torch.uint8, device=grad.device)
    check(launch(_launcher(), grad.device, *args, workspace.data_ptr(), ctypes.byref(size)),
          "gather_grad")
    gather_grad_cuda.launches += 1
    gather_grad_cuda.path_launches["vector" if vec else "scalar"] += 1
    return out


gather_grad_cuda.launches = 0
gather_grad_cuda.path_launches = {"vector": 0, "scalar": 0}


def gather_grad(grad: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Route by device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. No fallback: a failing launch raises, and so does a
    CUDA gradient of another dtype than float32 or bfloat16."""
    if grad.is_cuda:
        if idx.dtype != torch.int32:
            idx = torch.clamp(idx, max=n).to(torch.int32)
        return gather_grad_cuda(grad.contiguous(), idx.contiguous(), n)
    if grad.device.type != "cpu":
        raise ValueError(f"gather_grad: unsupported device {grad.device}")
    return gather_grad_plain(grad, idx, n)
