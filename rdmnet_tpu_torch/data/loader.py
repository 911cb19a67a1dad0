"""Host-side capacity bucketing and padding (twins of ``choose_bucket`` and
``pad_points_np`` in ``rdmnet_tpu/data/loader.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def choose_bucket(num_points: int, bucket_caps: Sequence[int]) -> int:
    """Index of the smallest bucket whose level-0 capacity fits
    ``num_points`` (the largest if none does). ``bucket_caps`` ascending."""
    for i, cap in enumerate(bucket_caps):
        if num_points <= cap:
            return i
    return len(bucket_caps) - 1


def pad_points_np(points: np.ndarray, cap: int, pad_coord: float = 1.0e9):
    """(cap, 3) float32 holding the first ``cap`` points, padded with
    ``pad_coord``; and the valid count as int32."""
    n = min(len(points), cap)
    out = np.full((cap, 3), pad_coord, np.float32)
    out[:n] = points[:n]
    return out, np.int32(n)
