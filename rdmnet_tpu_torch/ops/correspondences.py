"""Ground-truth correspondences on the device
(twin of ``rdmnet_tpu/ops/correspondences.py``, the three functions the
model and the losses call).

* ``node_correspondence_overlaps``: the dense (M, N) patch-overlap matrix;
* ``mutual_nearest_node_masks``: mutual-nearest node masks for the vote loss;
* ``radius_correspondence_masks``: per-point "has a partner within radius"
  labels of the overlap losses.

Labels are decided on the exact distances of ``ops/geometry`` (XLA's
float32 rounding), so they equal the JAX package's. Every output is a label:
nothing here carries a gradient, and inputs are detached.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rdmnet_tpu_torch.ops.geometry import apply_transform, pairwise_sq_dist
from rdmnet_tpu_torch.ops.select import top_k

BIG = 1.0e12


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 threshold on ``like``'s device, as JAX rounds a Python float."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


@torch.no_grad()
def node_correspondence_overlaps(ref_nodes: torch.Tensor, src_nodes: torch.Tensor,
                                 ref_knn_points: torch.Tensor, src_knn_points: torch.Tensor,
                                 transform: torch.Tensor, pos_radius: float,
                                 ref_masks: torch.Tensor, src_masks: torch.Tensor,
                                 ref_knn_masks: torch.Tensor, src_knn_masks: torch.Tensor,
                                 num_candidates: int = 3072, chunk: int = 256) -> torch.Tensor:
    """Dense ground-truth patch overlaps (M, N).

    overlap(i, j) is the mean of the fraction of patch i's points with a
    point of patch j within ``pos_radius`` and the converse, computed for the
    ``num_candidates`` node pairs whose enclosing spheres overlap most (by
    margin). The JAX package selects them with ``approx_max_k`` above M*N =
    num_candidates on the TPU (exact on the CPU); the port's top-k is exact.
    """
    m, k, _ = ref_knn_points.shape
    n = src_nodes.shape[0]
    src_nodes_t = apply_transform(src_nodes, transform)
    src_knn_t = apply_transform(src_knn_points.reshape(-1, 3), transform).reshape(n, k, 3)

    zero = torch.zeros((), dtype=ref_knn_points.dtype, device=ref_knn_points.device)
    ref_d = torch.linalg.norm(ref_knn_points - ref_nodes[:, None, :], dim=-1)
    ref_rmax = torch.where(ref_knn_masks, ref_d, zero).amax(dim=1)
    src_d = torch.linalg.norm(src_knn_t - src_nodes_t[:, None, :], dim=-1)
    src_rmax = torch.where(src_knn_masks, src_d, zero).amax(dim=1)

    node_dist = torch.sqrt(pairwise_sq_dist(ref_nodes, src_nodes_t))
    margin = ref_rmax[:, None] + src_rmax[None, :] + pos_radius - node_dist
    pair_mask = (margin > 0) & ref_masks[:, None] & src_masks[None, :]

    num_candidates = min(num_candidates, m * n)
    flat = torch.where(pair_mask, margin, torch.full_like(margin, -BIG)).reshape(-1)
    top_vals, cand = top_k(flat, num_candidates)
    cand_valid = top_vals > -BIG / 2
    cand_ref = torch.div(cand, n, rounding_mode="floor")
    cand_src = cand % n

    r2 = _f32(pos_radius ** 2, ref_knn_points)
    overlaps = []
    for start in range(0, num_candidates, chunk):
        ri, si = cand_ref[start:start + chunk], cand_src[start:start + chunk]
        rm, sm = ref_knn_masks[ri], src_knn_masks[si]                   # (C, K)
        d2 = pairwise_sq_dist(ref_knn_points[ri], src_knn_t[si])        # (C, K, K)
        hit = (d2 < r2) & rm[:, :, None] & sm[:, None, :]
        ref_ov = hit.any(dim=2).sum(dim=1).float() / torch.clamp_min(rm.sum(dim=1).float(), 1.0)
        src_ov = hit.any(dim=1).sum(dim=1).float() / torch.clamp_min(sm.sum(dim=1).float(), 1.0)
        overlaps.append(0.5 * (ref_ov + src_ov))
    overlaps = torch.where(cand_valid, torch.cat(overlaps), zero)

    dense = torch.zeros((m, n), dtype=torch.float32, device=ref_nodes.device)
    dense[cand_ref, cand_src] = overlaps  # candidates are distinct pairs
    return dense


@torch.no_grad()
def mutual_nearest_node_masks(ref_nodes: torch.Tensor, src_nodes: torch.Tensor,
                              transform: torch.Tensor, pos_radius: float,
                              ref_masks: torch.Tensor, src_masks: torch.Tensor) -> torch.Tensor:
    """(M, N) bool: each side's nearest valid node of the other side, if
    within ``pos_radius``. The reference compares the SQUARED distance with
    the unsquared radius; reproduced, so the vote loss sees its labels."""
    m, n = ref_nodes.shape[0], src_nodes.shape[0]
    dev = ref_nodes.device
    sq = pairwise_sq_dist(ref_nodes, apply_transform(src_nodes, transform))
    sq = torch.where(ref_masks[:, None] & src_masks[None, :], sq, torch.full_like(sq, BIG))
    radius = _f32(pos_radius, sq)

    masks = torch.zeros((m, n), dtype=torch.bool, device=dev)
    rows, cols = torch.arange(m, device=dev), torch.arange(n, device=dev)
    ref_arg = torch.argmin(sq, dim=1)   # first minimum, as jnp.argmin
    masks[rows, ref_arg] = sq.amin(dim=1) < radius
    src_arg = torch.argmin(sq, dim=0)
    masks[src_arg, cols] = masks[src_arg, cols] | (sq.amin(dim=0) < radius)
    return masks & ref_masks[:, None] & src_masks[None, :]


@torch.no_grad()
def radius_correspondence_masks(ref_points: torch.Tensor, src_points_t: torch.Tensor,
                                ref_mask: torch.Tensor, src_mask: torch.Tensor, radius: float,
                                chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point overlap labels: True iff a valid point of the other (already
    transformed) cloud lies within ``radius``. Queries run in chunks of
    ``chunk`` rows: a dense level-1 block at the 0.7 bucket (8704 x 8704) would
    be 300 MB in float32 and several times that in the exact distances'
    float64 temporaries."""

    def chunked_min(q, s, s_valid):
        mins = []
        for start in range(0, q.shape[0], chunk):
            d2 = pairwise_sq_dist(q[start:start + chunk], s)
            mins.append(torch.where(s_valid[None, :], d2, torch.full_like(d2, BIG)).amin(dim=1))
        return torch.cat(mins)

    r2 = _f32(radius * radius, ref_points)
    ref_min = chunked_min(ref_points, src_points_t, src_mask)
    src_min = chunked_min(src_points_t, ref_points, ref_mask)
    return (ref_min < r2) & ref_mask, (src_min < r2) & src_mask
