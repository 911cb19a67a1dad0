"""Point-to-node partition and kNN patch extraction
(twin of ``rdmnet_tpu/ops/partition.py``).

Each point is owned by its nearest valid node; each node keeps up to K of
its owned points, nearest first; missing slots carry the sentinel N.
``knn_partition`` keeps each node's k nearest points, owned or not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.ops.geometry import pairwise_sq_dist
from benchmark.reference.ops.select import top_k

BIG = 1.0e12


def knn_partition(points: torch.Tensor, nodes: torch.Tensor, k: int,
                  points_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest valid points of each node: points (N, 3), nodes (M, 3)
    -> (knn_sq_dists (M, k), knn_indices (M, k) int32), ascending; equal
    distances keep the lower index first (``ops/select.top_k``), masked
    points read as ``BIG``."""
    sq = pairwise_sq_dist(nodes, points)                                  # (M, N)
    if points_mask is not None:
        sq = torch.where(points_mask[None, :], sq, torch.full_like(sq, BIG))
    neg, idx = top_k(-sq, k)
    return -neg, idx.to(torch.int32)


def point_to_node_partition(points: torch.Tensor, points_mask: torch.Tensor,
                            nodes: torch.Tensor, nodes_mask: torch.Tensor,
                            point_limit: int) -> Tuple[torch.Tensor, ...]:
    """points (N, 3), points_mask (N,), nodes (M, 3), nodes_mask (M,) ->
    (point_to_node (N,) int32, node_masks (M,) bool,
     node_knn_indices (M, K) int32, node_knn_masks (M, K) bool)."""
    n, m = points.shape[0], nodes.shape[0]
    dev = points.device
    sq = pairwise_sq_dist(points, nodes)                                  # (N, M)
    sq = torch.where(nodes_mask[None, :], sq, torch.full_like(sq, BIG))
    # argmin returns the first minimum, as jnp.argmin
    point_to_node = torch.argmin(sq, dim=1)
    point_dist = sq.amin(dim=1)

    # lexicographic (owner, distance, index) order from two stable sorts:
    # tie order must equal lax.sort's
    owner_key = torch.where(points_mask, point_to_node, torch.full_like(point_to_node, m))
    by_dist = torch.sort(point_dist, stable=True).indices
    by_owner = torch.sort(owner_key[by_dist], stable=True).indices
    s_idx = by_dist[by_owner]
    s_owner = owner_key[s_idx]

    pos = torch.arange(n, device=dev)
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    changed[1:] = s_owner[1:] != s_owner[:-1]
    seg_start = torch.cummax(torch.where(changed, pos, torch.zeros_like(pos)), dim=0).values
    rank = pos - seg_start

    # Dropped scatters: the JAX version writes with mode="drop"; torch would
    # raise on an out-of-range index, so every slot that must not land
    # (invalid owner, rank >= K) is routed to a dump row m that is cut off
    slot_valid = (s_owner < m) & (rank < point_limit)
    row = torch.where(slot_valid, s_owner, torch.full_like(s_owner, m))
    col = torch.where(slot_valid, rank, torch.zeros_like(rank))
    table = torch.full((m + 1, point_limit), n, dtype=torch.int64, device=dev)
    table[row, col] = s_idx  # valid slots are unique; the dump row is discarded
    node_knn_indices = table[:m].to(torch.int32)
    node_knn_masks = node_knn_indices < n
    node_masks = node_knn_masks.any(dim=1) & nodes_mask
    return point_to_node.to(torch.int32), node_masks, node_knn_indices, node_knn_masks
