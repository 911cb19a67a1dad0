"""Point-cloud sampling and augmentation transforms, host-side numpy (twin of
``rdmnet_tpu/data/transforms.py``).

The GeoTransformer lineage's synthetic-benchmark toolkit: unit-sphere
normalisation, samplers, scale/shift/rotation/jitter, dropout, feature
jitter, and crops by a random plane or viewpoint. RDMNet's own KITTI
pipeline augments with ``utils/se3_np.augment_point_cloud_pair`` instead.
Every random transform takes an explicit ``rng`` (a numpy ``Generator`` or
``RandomState``), so the same seeded ``rng`` gives the JAX package's draws;
``random_dropout_points`` returns a copy; callers that pass normals always
get a pair back.
"""

from __future__ import annotations

import numpy as np


def normalize_points(points: np.ndarray) -> np.ndarray:
    """Center at the origin and scale into the unit sphere."""
    points = points - points.mean(axis=0)
    return points / np.max(np.linalg.norm(points, axis=1))


def sample_points(points, num_samples, normals=None):
    """First-K sampling."""
    if normals is not None:
        return points[:num_samples], normals[:num_samples]
    return points[:num_samples]


def random_sample_points(points, num_samples, normals=None, *, rng):
    """Random sampling; undersized clouds wrap the permutation around so
    the output is always exactly num_samples rows."""
    n = points.shape[0]
    sel = rng.permutation(n)
    if n > num_samples:
        sel = sel[:num_samples]
    elif n < num_samples:
        reps, rem = divmod(num_samples, n)
        sel = np.concatenate([np.tile(sel, reps), sel[:rem]])
    if normals is not None:
        return points[sel], normals[sel]
    return points[sel]


def random_scale_shift_points(points, low=2.0 / 3.0, high=3.0 / 2.0,
                              shift=0.2, normals=None, *, rng):
    """Anisotropic per-axis scale in [low, high) plus a uniform shift."""
    scale = rng.uniform(low=low, high=high, size=(1, 3))
    bias = rng.uniform(low=-shift, high=shift, size=(1, 3))
    out = points * scale + bias
    if normals is not None:
        normals = normals * scale
        normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)
        return out, normals
    return out


def random_rotate_points_along_up_axis(points, normals=None, *, rng):
    """Uniform random yaw about +z."""
    theta = rng.uniform(0.0, 2.0 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    # right-multiplication by R^T, matching the reference's convention
    rot_t = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    if normals is not None:
        return points @ rot_t, normals @ rot_t
    return points @ rot_t


def random_rescale_points(points, low=0.8, high=1.2, *, rng):
    """Isotropic random rescale."""
    return points * rng.uniform(low, high)


def random_jitter_points(points, scale, noise_magnitude=0.05, *, rng):
    """Gaussian jitter clipped to +/- noise_magnitude."""
    noise = np.clip(rng.normal(scale=scale, size=points.shape),
                    -noise_magnitude, noise_magnitude)
    return points + noise


def random_shuffle_points(points, normals=None, *, rng):
    """Random row permutation."""
    idx = rng.permutation(points.shape[0])
    if normals is not None:
        return points[idx], normals[idx]
    return points[idx]


def random_dropout_points(points, max_p, *, rng):
    """PointNet++-style dropout: each point is replaced by point 0 with a
    per-point probability in [0, max_p). Returns a copy."""
    n = points.shape[0]
    p = rng.random(n) * max_p
    drop = rng.random(n) < p
    out = points.copy()
    out[drop] = points[0]
    return out


def random_jitter_features(features, mu=0.0, sigma=0.01, *, rng):
    """FCGF feature jitter: applied with probability 0.95."""
    if rng.random() < 0.95:
        features = features + rng.normal(
            mu, sigma, features.shape
        ).astype(np.float32)
    return features


def random_sample_plane(*, rng) -> np.ndarray:
    """Unit normal of a random plane through the origin."""
    phi = rng.uniform(0.0, 2.0 * np.pi)
    theta = rng.uniform(0.0, np.pi)
    return np.array([
        np.sin(theta) * np.cos(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(theta),
    ])


def random_crop_point_cloud_with_plane(points, p_normal=None, keep_ratio=0.7,
                                       normals=None, *, rng):
    """Keep the keep_ratio fraction of points on the positive side of a
    random plane (largest signed distances)."""
    num_samples = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if p_normal is None:
        p_normal = random_sample_plane(rng=rng)
    sel = np.argsort(-(points @ p_normal))[:num_samples]
    if normals is not None:
        return points[sel], normals[sel]
    return points[sel]


def random_sample_viewpoint(limit=500, *, rng) -> np.ndarray:
    """Random observing point in one of the 8 far octants."""
    return rng.random(3) + limit * rng.choice([1.0, -1.0], size=3)


def random_crop_point_cloud_with_point(points, viewpoint=None, keep_ratio=0.7,
                                       normals=None, *, rng):
    """Keep the keep_ratio fraction of points nearest a random viewpoint."""
    num_samples = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if viewpoint is None:
        viewpoint = random_sample_viewpoint(rng=rng)
    sel = np.argsort(np.linalg.norm(viewpoint - points, axis=1))[:num_samples]
    if normals is not None:
        return points[sel], normals[sel]
    return points[sel]
