"""Greedy sequential radius NMS over nodes (twin of ``rdmnet_tpu/ops/nms.py``).

Keep node i iff no already-kept, earlier-indexed node lies within
``radius``: the lexicographically-first maximal independent set, found by
parallel peeling. Each round confirms every active node with no earlier
active neighbour and kills the later actives that see a confirmed one. The
JAX package runs the rounds in a ``while_loop`` on the device; here
``ops/kernels/nms.nms_peel`` does: on the card one kernel launch runs every
round (no host round trip), on the CPU a Python loop on ``active.any()``
(rounds = suppression-chain depth, typically < 10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.ops.geometry import pairwise_sq_dist
from benchmark.reference.kernels import nms_peel


def nms_adjacency(nodes: torch.Tensor, nodes_mask: torch.Tensor, radius: float,
                  neighbor_limit: Optional[int] = None) -> torch.Tensor:
    """nodes (B, M, 3), nodes_mask (B, M) bool -> the strict-lower adjacency
    (B, M, M) bool the peeling reads: row i, column j < i, both valid.

    Strict ``<`` adjacency (a pair exactly at the radius does not suppress).
    ``neighbor_limit`` truncates each row's adjacency to its nearest entries
    (self included, ties by index) for parity with the reference's lists.
    """
    m = nodes.shape[1]
    dev = nodes.device
    sq = torch.stack([pairwise_sq_dist(n, n) for n in nodes])
    r2 = torch.full((), radius * radius, dtype=torch.float32, device=dev)
    adj = (sq < r2) & nodes_mask[:, None, :] & nodes_mask[:, :, None]
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    if neighbor_limit is not None:
        dmat = torch.where(adj | eye, torch.sqrt(sq), torch.full_like(sq, float("inf")))
        order = torch.sort(dmat, dim=2, stable=True).indices
        rank = torch.sort(order, dim=2, stable=True).indices
        adj = adj & (rank < neighbor_limit)
    adj = adj & ~eye
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=dev), diagonal=-1)
    return adj & earlier


def greedy_nms(nodes: torch.Tensor, nodes_mask: torch.Tensor, radius: float,
               neighbor_limit: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """nodes (B, M, 3), nodes_mask (B, M) bool -> (keep (B, M) bool, rounds
    () int32 tensor, the most any cloud took), on ``nms_adjacency``."""
    return nms_peel(nms_adjacency(nodes, nodes_mask, radius, neighbor_limit), nodes_mask)
