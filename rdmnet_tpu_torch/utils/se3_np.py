"""Host-side (numpy) SE(3) helpers and training augmentation (own copy of
``rdmnet_tpu/utils/se3_np.py``). Augmentation draws from a
``np.random.RandomState`` in the JAX package's order, so one seed gives the
same augmented pair bit for bit."""

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


def euler_zyx_matrix(az: float, ay: float, ax: float) -> np.ndarray:
    """Extrinsic z-y-x euler rotation (scipy's ``from_euler('zyx', [az, ay,
    ax])``): about the fixed z, then y, then x axes, i.e. Rx @ Ry @ Rz."""
    cz, sz = np.cos(az), np.sin(az)
    cy, sy = np.cos(ay), np.sin(ay)
    cx, sx = np.cos(ax), np.sin(ax)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return rx @ ry @ rz


def random_sample_rotation(rng: np.random.RandomState, rotation_factor: float = 1.0) -> np.ndarray:
    """Euler angles uniform in [0, 2 pi / rotation_factor)."""
    euler = rng.rand(3) * np.pi * 2 / rotation_factor
    return euler_zyx_matrix(*euler)


def augment_point_cloud_pair(
    rng: np.random.RandomState,
    ref_points: np.ndarray,
    src_points: np.ndarray,
    transform: np.ndarray,
    noise: float = 0.01,
    min_scale: float = 0.8,
    max_scale: float = 1.2,
    shift: float = 2.0,
    rotation_factor: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Training augmentation (reference kitti/dataset.py:108-136): uniform
    jitter, a random rotation of ref or src (p=0.5), a global scale, a shift
    per cloud; the ground-truth transform recomposed. float32 out."""
    rotation, translation = get_rotation_translation_from_transform(transform)

    ref_points = ref_points + (rng.rand(*ref_points.shape) - 0.5) * noise
    src_points = src_points + (rng.rand(*src_points.shape) - 0.5) * noise

    aug_rotation = random_sample_rotation(rng, rotation_factor)
    if rng.rand() > 0.5:
        ref_points = ref_points @ aug_rotation.T
        rotation = aug_rotation @ rotation
        translation = aug_rotation @ translation
    else:
        src_points = src_points @ aug_rotation.T
        rotation = rotation @ aug_rotation.T

    scale = min_scale + (max_scale - min_scale) * rng.rand()
    ref_points = ref_points * scale
    src_points = src_points * scale
    translation = translation * scale

    ref_shift = rng.uniform(-shift, shift, 3)
    src_shift = rng.uniform(-shift, shift, 3)
    ref_points = ref_points + ref_shift
    src_points = src_points + src_shift
    translation = -(src_shift[None, :] @ rotation.T)[0] + translation + ref_shift

    transform = get_transform_from_rotation_translation(rotation, translation)
    return (
        ref_points.astype(np.float32),
        src_points.astype(np.float32),
        transform.astype(np.float32),
    )
