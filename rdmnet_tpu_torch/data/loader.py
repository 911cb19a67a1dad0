"""Host-side capacity bucketing (twin of ``choose_bucket`` in
``rdmnet_tpu/data/loader.py``)."""

from __future__ import annotations

from typing import Sequence


def choose_bucket(num_points: int, bucket_caps: Sequence[int]) -> int:
    """Index of the smallest bucket whose level-0 capacity fits
    ``num_points`` (the largest if none does). ``bucket_caps`` ascending."""
    for i, cap in enumerate(bucket_caps):
        if num_points <= cap:
            return i
    return len(bucket_caps) - 1
