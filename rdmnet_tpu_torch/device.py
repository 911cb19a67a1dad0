"""Device selection and numeric policy of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one. A CUDA request on a host without a card raises instead of
    silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rdmnet_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain versions"
            )
        set_precision()
    return dev


def set_precision() -> None:
    """Full float32 matrix products and convolutions on the card: geometry,
    Sinkhorn and pose math are float32 by contract, and TF32 keeps only
    about three decimal digits. bfloat16 products (``compute_dtype``)
    accumulate in float32 as XLA's do: no reduced-precision split-K sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
