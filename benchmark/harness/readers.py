"""Shared arithmetic of the per-layer metric readers (``benchmark/metrics``).
Each returns None where the run has nothing to read."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.counts.flops import share_of_peak
from benchmark.counts.peaks import F32_FLOPS


def idle_share(run, worst: bool = False) -> Optional[float]:
    """Percent of the traced window with no kernel, copy or set on the card
    (the mean over the ranks' cards, or the worst one)."""
    shares = [100.0 * (1.0 - tl.busy_s() / tl.window_s) for tl in run.timelines if tl.window_s > 0]
    if not shares:
        return None
    return max(shares) if worst else sum(shares) / len(shares)


def mfu(run) -> Optional[float]:
    """The whole step's share of the float32 peak: FLOPs a pair (the
    reference's products at the padded capacities, ``counts/flops.py``)
    times the window's pairs a second of one card."""
    if not run.flops_per_item or not run.window_s or not run.items:
        return None
    return share_of_peak(run.flops_per_item, run.items / run.window_s / run.device_count,
                         F32_FLOPS)


def kernel_ms_per_call(run, patterns: Sequence[str]) -> Optional[float]:
    """Device ms a traced call of the kernels whose names hold one of
    ``patterns`` (the first rank's trace)."""
    tl = run.timeline
    if tl is None or not tl.calls:
        return None
    sec = tl.op_seconds(lambda name: any(p in name for p in patterns))
    return sec * 1e3 / tl.calls if sec > 0 else None


def roofline(run, bound_key: str, patterns: Sequence[str]) -> Optional[float]:
    """Percent of the kernels' device time that their bound is."""
    bound = run.bounds_ms.get(bound_key)
    ms = kernel_ms_per_call(run, patterns)
    if not bound or not ms:
        return None
    return 100.0 * bound / ms


def mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None
