"""Model FLOPs: the matrix products (``mm``, ``addmm``, ``bmm``, ...) of the
plain reference's own pass over a pair, counted by PyTorch's
``FlopCounterMode`` at the shapes the program runs (the bucket's padded
capacities). The reference computes the same products as the port's
model, so the count is the work one served pair or training step asks of
the card; the port's kernels (kNN, voxel sums, NMS, Sinkhorn, eigh) are not
products and are counted by their own bounds (``bounds.py``)."""

from __future__ import annotations

from typing import Callable, Tuple


def counted(fn: Callable[[], object]) -> Tuple[object, int]:
    """(``fn()``, the FLOPs of its matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, int(counter.get_total_flops())


def share_of_peak(flops_per_item: float, items_per_s: float, peak_flops: float) -> float:
    """Percent of ``peak_flops`` that ``flops_per_item`` at ``items_per_s`` is."""
    return 100.0 * flops_per_item * items_per_s / peak_flops
