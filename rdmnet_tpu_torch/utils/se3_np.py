"""Host-side (numpy) SE(3) helpers (own copy of the part of
``rdmnet_tpu/utils/se3_np.py`` the port reads; augmentation comes with the
data-pipeline slice)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def apply_transform(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    return points @ transform[:3, :3].T + transform[:3, 3]


def get_transform_from_rotation_translation(rotation, translation) -> np.ndarray:
    transform = np.eye(4)
    transform[:3, :3] = rotation
    transform[:3, 3] = translation
    return transform


def get_rotation_translation_from_transform(transform) -> Tuple[np.ndarray, np.ndarray]:
    return transform[:3, :3], transform[:3, 3]


def inverse_transform(transform: np.ndarray) -> np.ndarray:
    r, t = get_rotation_translation_from_transform(transform)
    return get_transform_from_rotation_translation(r.T, -r.T @ t)
