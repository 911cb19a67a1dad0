"""Device and matrix-product precision of the reference."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device the reference runs on (CUDA unless named). It leaves the
    matrix-product precision alone: the caller sets it (``set_precision``)."""
    return torch.device("cuda" if device is None else device)


def set_precision(tf32: bool = False) -> None:
    """Float32 products as the configuration states them (``tf32=False``:
    full float32, no reduced-precision sums), or TF32 products, the control
    that has to fail the comparison."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
