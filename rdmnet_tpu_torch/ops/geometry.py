"""Core geometric tensor ops: distances, sentinel gathers, SE(3) helpers.

Twin of ``rdmnet_tpu/ops/geometry.py``. All functions work on plain
tensors and keep the JAX package's layouts.

Exact 3-D distances. The JAX package computes ``|x|^2 - 2 x.y + |y|^2``
with a 3-deep dot product, and XLA's CPU backend rounds that as a chain of
fused multiply-adds (``fma(x2, y2, fma(x1, y1, x0*y0))``, the squared norms
the same way). At LiDAR coordinates (|x|^2 ~ 6400 m^2) the result is
quantised to ~5e-4 m^2, so neighbour orders and radius cut-offs depend on
those exact roundings. ``sq_dist3`` reproduces them: each fused step is
computed in float64 (the float32 product is exact there) and rounded once
to float32, so index tables built on them match the JAX package exactly,
and the CUDA kernel (``csrc/radius_knn.cu``, ``__fmaf_rn``) matches them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def f32_reciprocal(value: float, like: torch.Tensor) -> torch.Tensor:
    """float32 ``1 / value`` as a scalar tensor on ``like``'s device.

    Quantisations such as ``floor(x / cell)`` decide voxel keys and band
    windows, so they must round as the JAX package does: XLA rewrites a
    division by a constant into a multiplication by the constant's float32
    reciprocal, and the port multiplies by the same reciprocal explicitly
    (a plain ``x / cell`` would divide on the CPU and multiply on CUDA).
    Filled on the device: no copy from host memory (a CUDA graph refuses one)."""
    recip = np.float32(1.0) / np.float32(value)
    return torch.full((), float(recip), dtype=torch.float32, device=like.device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``round(a*b + c)``: the product is exact in float64, so this
    is a single float32 rounding (up to a rare double-rounding tie)."""
    return (a.double() * b.double() + c.double()).float()


def dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Broadcast ``sum_i x[..., i] * y[..., i]`` over the last axis of size 3
    as the fused chain ``fma(x2, y2, fma(x1, y1, x0 * y0))``."""
    acc = x[..., 0] * y[..., 0]
    acc = fma32(x[..., 1], y[..., 1], acc)
    return fma32(x[..., 2], y[..., 2], acc)


def sq_norm3(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...,) squared norm with the fused rounding of ``dot3``."""
    return dot3(x, x)


def sq_dist3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(*, N, 3), (*, M, 3) -> (*, N, M) ``max(|x|^2 - 2 x.y + |y|^2, 0)``
    with the JAX package's float32 rounding (module docstring)."""
    xy = dot3(x[..., :, None, :], y[..., None, :, :])
    sq = (sq_norm3(x)[..., :, None] - 2.0 * xy) + sq_norm3(y)[..., None, :]
    return torch.clamp_min(sq, 0.0)


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """Squared euclidean distances between rows of x (*, N, C) and y (*, M, C),
    clamped at zero. Points (C = 3) take the exact path of ``sq_dist3``;
    unit-norm feature rows (``normalized``) ``2 - 2 x.y``, and feature rows of
    any other width ``|x|^2 - 2 x.y + |y|^2``, float32 matmuls."""
    if x.dim() < 2:
        raise ValueError(f"pairwise_sq_dist: expected (*, N, C) rows, got {tuple(x.shape)}")
    if normalized:
        return torch.clamp_min(2.0 - 2.0 * (x @ y.transpose(-1, -2)), 0.0)
    if x.shape[-1] == 3:
        return sq_dist3(x, y)
    xy = x @ y.transpose(-1, -2)
    sq = ((x * x).sum(-1)[..., :, None] - 2.0 * xy) + (y * y).sum(-1)[..., None, :]
    return torch.clamp_min(sq, 0.0)


def _lookup(x: torch.Tensor, indices: torch.Tensor, fill_value: float) -> torch.Tensor:
    n = x.shape[0]
    fill = torch.full((1,) + tuple(x.shape[1:]), fill_value, dtype=x.dtype, device=x.device)
    ext = torch.cat([x, fill], dim=0).reshape(n + 1, -1)
    idx = torch.clamp(indices.long(), max=n)
    out = torch.nn.functional.embedding(idx, ext, padding_idx=n)
    return out.reshape(tuple(indices.shape) + tuple(x.shape[1:]))


class _TakePadded(torch.autograd.Function):
    """``take_padded`` under autograd: the same lookup forward, and as its
    backward the gather-sum of ``ops/kernels/gather_grad``, which sums each
    row's gathered gradient rows in position order and never reads the
    sentinel positions."""

    @staticmethod
    def forward(ctx, x, indices, fill_value):
        ctx.save_for_backward(indices)
        ctx.rows = x.shape[0]
        return _lookup(x, indices, fill_value)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        # imported here: the kernels' package imports this module
        from rdmnet_tpu_torch.ops.kernels.gather_grad import gather_grad

        (indices,) = ctx.saved_tensors
        trailing = tuple(grad.shape[indices.dim():])
        flat = gather_grad(grad.reshape(indices.numel(), -1), indices.reshape(-1), ctx.rows)
        return flat.reshape((ctx.rows,) + trailing), None, None


def take_padded(x: torch.Tensor, indices: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Gather rows of float ``x`` (N, ...) by ``indices`` of any shape.

    Sentinel gathers: an index >= N yields a ``fill_value`` row, as
    ``jnp.take(mode="fill")`` does. Implemented with one appended fill row
    and indices clamped to it (torch would raise on the out-of-range ones):
    an embedding lookup with the fill row as its padding index, run inside
    ``_TakePadded``. Where autograd records (grad mode on, ``x`` requiring
    grad) its backward is the gather-sum kernel on the card and its plain
    version on the CPU; otherwise the lookup is all that runs.
    """
    return _TakePadded.apply(x, indices, fill_value)


def get_transform_from_rotation_translation(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) + (*, 3) -> (*, 4, 4)."""
    batch = rotation.shape[:-2]
    transform = torch.zeros(batch + (4, 4), dtype=rotation.dtype, device=rotation.device)
    transform[..., :3, :3] = rotation
    transform[..., :3, 3] = translation
    transform[..., 3, 3].fill_(1.0)  # a Python scalar assigned by index is a host copy
    return transform


def get_rotation_translation_from_transform(transform: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return transform[..., :3, :3], transform[..., :3, 3]


def apply_transform(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """(*, 3) points with one (4, 4) transform, or (B, N, 3) with (B, 4, 4).

    With one transform each rotated coordinate is the fused chain of
    ``dot3``, XLA's rounding of the 3-deep product, on either device:
    ground-truth labels decided on transformed points
    (``ops/correspondences``, the losses' radii) then equal the JAX
    package's. The batched form (LGR's hypotheses) is a plain matmul: its
    float64 temporaries would be ~200 MB each there."""
    rotation = transform[..., :3, :3]
    translation = transform[..., :3, 3]
    if transform.dim() == 2:
        return dot3(points[..., None, :], rotation) + translation
    return points @ rotation.transpose(-1, -2) + translation[..., None, :]


def apply_rotation(points: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """(*, 3) points with one (3, 3) rotation (the fused chain of ``dot3``, as
    ``apply_transform``), or (B, N, 3) with (B, 3, 3) (a matmul)."""
    if rotation.dim() == 2:
        return dot3(points[..., None, :], rotation)
    return points @ rotation.transpose(-1, -2)


def inverse_transform(transform: torch.Tensor) -> torch.Tensor:
    """Invert (*, 4, 4) rigid transform(s)."""
    rotation, translation = get_rotation_translation_from_transform(transform)
    inv_rotation = rotation.transpose(-1, -2)
    inv_translation = -(inv_rotation @ translation[..., None])[..., 0]
    return get_transform_from_rotation_translation(inv_rotation, inv_translation)


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim=None, eps: float = 1e-12) -> torch.Tensor:
    """Mean over entries where ``mask`` is True (all of them, or along ``dim``)."""
    mask = mask.to(values.dtype)
    total = (values * mask).sum() if dim is None else (values * mask).sum(dim)
    count = mask.sum() if dim is None else mask.sum(dim)
    return total / torch.clamp_min(count, eps)


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """(*, 3) -> (*, 3, 3) cross-product matrix."""
    zeros = torch.zeros_like(v[..., 0])
    rows = [torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1)]
    return torch.stack(rows, dim=-2)


def rodrigues_rotation(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis (*, 3) and angle (*) -> rotation matrix (*, 3, 3)."""
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-12)
    k = skew_symmetric(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    sin = torch.sin(angle)[..., None, None]
    cos = torch.cos(angle)[..., None, None]
    return eye + sin * k + (1.0 - cos) * (k @ k)


def vector_angle(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Angle between vectors along the last axis, ``atan2(|x × y|, x · y)``."""
    cross = torch.linalg.norm(torch.linalg.cross(x, y, dim=-1), dim=-1)
    return torch.atan2(cross, (x * y).sum(-1))


def masked_min(values: torch.Tensor, mask: torch.Tensor, dim: int,
               big: float = 1e12) -> Tuple[torch.Tensor, torch.Tensor]:
    """min and argmin along ``dim`` with ``mask == False`` entries read as
    ``big``; argmin returns the first minimum, as ``jnp.argmin``."""
    masked = torch.where(mask, values, torch.full_like(values, big))
    return masked.amin(dim=dim), torch.argmin(masked, dim=dim)
