"""Selection with the JAX package's tie order.

Tie order: ``lax.top_k`` returns equal values lower index first;
``torch.topk`` makes no such promise. ``top_k`` here uses a stable sort
(argmax for k=1, which returns the first maximum), so index outputs match.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` entries along ``dim``, descending, ties by lower index."""
    if k == 1:
        idx = torch.argmax(x, dim=dim, keepdim=True)
        return torch.gather(x, dim, idx), idx
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)
