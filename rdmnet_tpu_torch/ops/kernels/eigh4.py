"""Top eigenvector of symmetric 4 x 4 matrices (Horn's quaternion): CUDA
kernel wrapper and its plain PyTorch version.

Kernel: ``csrc/eigh4.cu``. It replaces no TPU kernel: the JAX package's Horn
solver calls ``jnp.linalg.eigh`` (``rdmnet_tpu/ops/procrustes.py:49``), which
XLA lowers without Pallas. The plain version is ``torch.linalg.eigh``, which
the CPU keeps; on CUDA it waits for the host, so the card takes the kernel
(cyclic Jacobi in float32, a thread per matrix). Both return, for each
(..., 4, 4) symmetric matrix (its lower triangle), a unit eigenvector of its
largest eigenvalue. The sign of a vector is free, and where the top two
eigenvalues lie close it is defined only to float32 rounding over their gap,
so the two versions are compared through the rotation the vector gives.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rdmnet_tpu_torch.ops.kernels._build import check, launch, load_library


def top_eigenvector_plain(k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (..., 4, 4) -> (..., 4), ``torch.linalg.eigh``'s
    last (largest) eigenvector."""
    return torch.linalg.eigh(k).eigenvectors[..., -1]


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load_library("eigh4").eigh4_top_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def eigh4_cuda(k: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the tensor's card (one
    launch per call): (..., 4, 4) contiguous float32 -> (..., 4). ``launches``
    counts every launch."""
    if not k.is_cuda or k.dtype != torch.float32 or not k.is_contiguous():
        raise ValueError("eigh4_cuda: k must be a contiguous CUDA float32 tensor")
    if k.dim() < 2 or k.shape[-2:] != (4, 4):
        raise ValueError(f"eigh4_cuda: expected (..., 4, 4), got {tuple(k.shape)}")
    n = k.numel() // 16
    out = torch.empty(k.shape[:-1], dtype=torch.float32, device=k.device)
    err = launch(_launcher(), k.device, k.data_ptr(), n, out.data_ptr())
    check(err, "eigh4")
    eigh4_cuda.launches += 1
    eigh4_cuda.path_launches["jacobi"] += 1
    return out


eigh4_cuda.launches = 0
eigh4_cuda.path_launches = {"jacobi": 0}  # one path: a thread per matrix


def top_eigenvector(k: torch.Tensor) -> torch.Tensor:
    """Route by device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. No fallback: a failing launch raises."""
    if k.is_cuda:
        return eigh4_cuda(k.float().contiguous())
    if k.device.type != "cpu":
        raise ValueError(f"top_eigenvector: unsupported device {k.device}")
    return top_eigenvector_plain(k)
