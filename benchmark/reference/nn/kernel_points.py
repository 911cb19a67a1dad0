"""Kernel point dispositions for KPConv (twin of ``rdmnet_tpu/nn/kernel_points.py``).

The canonical 15-point 'center' disposition (unit scale) as data; other
kernel sizes use a fixed-seed repulsion optimisation. The random load-time
rotation/jitter of the reference is not part of inference: converted
weights carry each layer's own kernel points.
"""

from __future__ import annotations

import numpy as np

KERNEL_POINTS_15 = np.array(
    [
        [0.0, 0.0, 0.0],
        [-0.49820612, 0.41826797, 0.11736718],
        [-0.24123565, -0.34214048, -0.5115481],
        [-0.2828808, -0.58614266, 0.11553228],
        [0.29054036, -0.10093209, -0.585091],
        [0.42820039, 0.39929883, -0.30681813],
        [-0.63586493, -0.08196441, -0.16090403],
        [-0.43181082, -0.14729417, 0.47830957],
        [-0.044666, 0.27973214, 0.59723308],
        [0.22552417, -0.34462544, 0.50794659],
        [0.63889212, -0.16914906, -0.01190108],
        [-0.22552415, 0.34462545, -0.50794659],
        [0.49054666, 0.26880703, 0.35219206],
        [0.25233084, -0.59706653, -0.12951142],
        [0.03415394, 0.65858341, 0.04513958],
    ],
    dtype=np.float32,
)


def _repulsion_dispositions(num_points: int, seed: int = 7351, steps: int = 200) -> np.ndarray:
    """Fixed-seed repulsion of ``num_points`` points in the unit ball with a
    fixed centre point (kernel sizes other than 15)."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(num_points, 3).astype(np.float64)
    pts[0] = 0.0
    pts[1:] /= np.linalg.norm(pts[1:], axis=1, keepdims=True) / 0.5
    lr = 0.01
    for _ in range(steps):
        diff = pts[:, None] - pts[None]
        d = np.linalg.norm(diff, axis=-1) + 1e-6
        force = (diff / d[..., None] ** 3).sum(1) - 2.0 * pts
        force[0] = 0.0
        pts += lr * force
        r = np.linalg.norm(pts[1:], axis=1, keepdims=True)
        pts[1:] = np.where(r > 1.0, pts[1:] / r, pts[1:])
    r = np.linalg.norm(pts[1:], axis=1)
    pts[1:] *= 0.66 / r.mean()
    return pts.astype(np.float32)


def make_kernel_points(radius: float, num_points: int = 15) -> np.ndarray:
    """(num_points, 3) float32 kernel point positions scaled to ``radius``."""
    base = KERNEL_POINTS_15 if num_points == 15 else _repulsion_dispositions(num_points)
    return (np.float32(radius) * base).astype(np.float32)
