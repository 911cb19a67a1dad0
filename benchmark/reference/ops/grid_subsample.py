"""Fixed-capacity voxel-grid subsampling (twin of ``rdmnet_tpu/ops/grid_subsample.py``).

Each occupied voxel of side ``voxel_size`` emits the centroid of its points.
Output voxels are ordered by the x-major packed voxel key, the order the
banded radius search relies on. Batched over a leading axis (the pair).

Segment sums: the JAX package sums each voxel's points with
``segment_sum``, which XLA evaluates sequentially in sorted order in float32.
``index_add_``/``scatter_add_`` on CUDA add in a nondeterministic order, and
a float32 ``cumsum`` difference loses precision against the running total.
Here each sorted segment is summed left to right in float32 exactly as XLA
does, deterministically (``ops/kernels/segment_sum``): on the CPU column by
column (step j adds every segment's j-th point), on the card by a kernel
with a thread per segment, which needs no host round trip.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark.reference.ops.geometry import f32_reciprocal
from benchmark.reference.kernels import segment_sums

PAD_COORD = 1.0e9  # coordinate of padded output slots

# Voxel-key packing: 11/10/10 bits (x/y/z), x primary; cx clipped to 2046 so
# the largest key stays below the invalid-point sentinel.
_CLIP = (2046, 1023, 1023)
INVALID_KEY = 2 ** 31 - 1


def voxel_sort_key(points: torch.Tensor, valid: torch.Tensor, cell: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) points, (B, N) bool -> (key (B, N) int32, n_clipped (B,) int32).

    Grid anchored at floor(min / cell) * cell over valid points. Invalid
    points get the int32-max key. ``n_clipped`` counts valid points whose
    voxel coordinate fell outside the packable range."""
    c = torch.full((), cell, dtype=torch.float32, device=points.device)
    inv = f32_reciprocal(cell, points)
    masked = torch.where(valid[..., None], points, torch.full_like(points, float("inf")))
    anchor = torch.floor(masked.amin(dim=1, keepdim=True) * inv) * c
    coords = torch.floor((points - anchor) * inv)
    # clamp in float before the cast: pad rows sit at 1e9 and would overflow
    coords = torch.clamp(coords, -1.0, 4096.0).to(torch.int32)
    cx = coords[..., 0].clamp(0, _CLIP[0])
    cy = coords[..., 1].clamp(0, _CLIP[1])
    cz = coords[..., 2].clamp(0, _CLIP[2])
    clipped = ((coords[..., 0] > _CLIP[0]) | (coords[..., 1] > _CLIP[1])
               | (coords[..., 2] > _CLIP[2])) & valid
    key = (cx << 20) | (cy << 10) | cz
    key = torch.where(valid, key, torch.full_like(key, INVALID_KEY))
    return key, clipped.sum(dim=1).to(torch.int32)


def voxel_sort_key_np(points, cell: float):
    """Numpy twin of the JAX package's ``voxel_sort_key_np`` for host paths
    (``graph/native.py``): the anchor, bit layout and ``_CLIP`` of
    ``voxel_sort_key``, in float32 with a true division as numpy computes
    it. All points are valid (host callers truncate instead of padding)."""
    anchor = np.floor(points.min(axis=0) / cell) * cell
    coords = np.floor((points - anchor) / cell).astype(np.int64)
    return (
        (np.clip(coords[:, 0], 0, _CLIP[0]) << 20)
        | (np.clip(coords[:, 1], 0, _CLIP[1]) << 10)
        | np.clip(coords[:, 2], 0, _CLIP[2])
    )


def voxel_segments(points: torch.Tensor, num_valid: torch.Tensor, voxel_size: float, cap: int):
    """The segment layout of ``grid_subsample``: the points sorted by voxel
    key and, for each of the first ``cap`` occupied voxels, its first sorted
    row and its length (the ``segment_sums`` inputs).

    Returns (sorted_pts (B, N, 3), start (B, cap) int64, length (B, cap)
    int64, true_count (B,) int64 occupied voxels, n_clipped (B,) int32)."""
    b, n, _ = points.shape
    dev = points.device
    pos = torch.arange(n, device=dev)
    valid = pos[None, :] < num_valid[:, None]
    key, n_clipped = voxel_sort_key(points, valid, voxel_size)

    # tie order: a stable sort keeps equal keys in input order, as lax.sort
    skey, order = torch.sort(key, dim=1, stable=True)
    sorted_pts = torch.gather(points, 1, order[..., None].expand(b, n, 3))
    svalid = skey != INVALID_KEY

    changed = (skey[:, 1:] != skey[:, :-1]).to(torch.int64)
    seg = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                     torch.cumsum(changed, dim=1)], dim=1)
    true_count = torch.where(
        num_valid > 0,
        torch.where(svalid, seg, torch.full_like(seg, -1)).amax(dim=1) + 1,
        torch.zeros_like(num_valid, dtype=torch.int64),
    )

    # segment layout on the sorted axis: first position and length of each
    # kept segment (row `cap` collects invalid points and overflow segments)
    sid = torch.where(svalid, torch.clamp(seg, max=cap), torch.full_like(seg, cap))
    start = torch.full((b, cap + 1), n, dtype=torch.int64, device=dev)
    start.scatter_reduce_(1, sid, pos.expand(b, n), reduce="amin")
    length = torch.zeros((b, cap + 1), dtype=torch.int64, device=dev)
    length.scatter_add_(1, sid, torch.ones_like(sid))
    return sorted_pts, start[:, :cap], length[:, :cap], true_count, n_clipped


def grid_subsample(points: torch.Tensor, num_valid: torch.Tensor, voxel_size: float, cap: int):
    """Voxel-centroid subsample of padded clouds.

    Args:
      points: (B, N, 3) float32; the first ``num_valid[b]`` rows are real.
      num_valid: (B,) int32.
      voxel_size: voxel edge length.
      cap: output capacity (occupied voxels beyond it are dropped).

    Returns (sub_points (B, cap, 3) with pad rows at 1e9, sub_count (B,)
    int32, dropped (B,) int32 = overflow voxels + clipped points).
    """
    dev = points.device
    sorted_pts, start, length, true_count, n_clipped = voxel_segments(points, num_valid,
                                                                     voxel_size, cap)
    sub_count = torch.clamp(true_count, max=cap)
    sums = segment_sums(sorted_pts, start, length)
    counts = length.to(points.dtype)

    out_valid = torch.arange(cap, device=dev)[None, :] < sub_count[:, None]
    centroids = sums / torch.clamp_min(counts, 1.0)[..., None]
    sub_points = torch.where(out_valid[..., None], centroids, torch.full_like(centroids, PAD_COORD))
    dropped = torch.clamp_min(true_count - cap, 0) + n_clipped
    return sub_points, sub_count.to(torch.int32), dropped.to(torch.int32)
