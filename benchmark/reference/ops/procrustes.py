"""Weighted Procrustes pose solver (twin of ``rdmnet_tpu/ops/procrustes.py``).

Horn's unit-quaternion method: the rotation is the top eigenvector of a
symmetric 4x4 built from the weighted cross-covariance
(``ops/kernels/eigh4.top_eigenvector`` over a batch: ``torch.linalg.eigh`` on
the CPU, on the card a Jacobi kernel that needs no host round trip). Kept instead of SVD Kabsch: LiDAR cross-covariances are
anisotropic, where float32 SVD loses the weak subspace, while Horn needs
only the top eigenvector and yields a proper rotation by construction.
Float32 throughout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.ops.geometry import get_transform_from_rotation_translation
from benchmark.reference.kernels import top_eigenvector


def horn_matrix(h: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric (..., 4, 4) matrix of (..., 3, 3) H[a, b] =
    sum_i w_i src_c[i, a] ref_c[i, b]: the rotation's unit quaternion is its
    top eigenvector."""
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    return torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1),
    ], -2)


def horn_rotation(h: torch.Tensor) -> torch.Tensor:
    """Proper rotation R maximising tr(R H) from (..., 3, 3) H[a, b] =
    sum_i w_i src_c[i, a] ref_c[i, b]."""
    k = horn_matrix(h)
    # degenerate H (no correspondences, K = 0) must give the identity: bias
    # the identity quaternion's entry far below any real K's resolution
    bias = 1e-12 + 1e-9 * h.abs().sum((-1, -2))
    k = k.clone()
    k[..., 0, 0] = k[..., 0, 0] + bias
    q = top_eigenvector(k)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def cross_covariance(src_points: torch.Tensor, ref_points: torch.Tensor,
                     weights: Optional[torch.Tensor] = None, weight_thresh: float = 0.0,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weighted fit's (..., 3, 3) H and (..., 1, 3) src and ref centroids."""
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], dtype=src_points.dtype,
                             device=src_points.device)
    weights = torch.where(weights < weight_thresh, torch.zeros_like(weights), weights)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    w = weights[..., None]
    src_centroid = (src_points * w).sum(dim=-2, keepdim=True)
    ref_centroid = (ref_points * w).sum(dim=-2, keepdim=True)
    src_c = src_points - src_centroid
    ref_c = ref_points - ref_centroid
    return src_c.transpose(-1, -2) @ (w * ref_c), src_centroid, ref_centroid


def weighted_procrustes(src_points: torch.Tensor, ref_points: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        weight_thresh: float = 0.0, eps: float = 1e-5) -> torch.Tensor:
    """(..., N, 3) src, ref, (..., N) weights -> (..., 4, 4) with
    R @ src + t ~= ref. Zero-weight rows are ignored."""
    h, src_centroid, ref_centroid = cross_covariance(src_points, ref_points, weights,
                                                     weight_thresh, eps)
    r = horn_rotation(h)
    t = ref_centroid[..., 0, :] - (r @ src_centroid.transpose(-1, -2))[..., 0]
    return get_transform_from_rotation_translation(r, t)
