"""Greedy sequential radius NMS over nodes (twin of ``rdmnet_tpu/ops/nms.py``).

Keep node i iff no already-kept, earlier-indexed node lies within
``radius``: the lexicographically-first maximal independent set, found by
parallel peeling. Each round confirms every active node with no earlier
active neighbour and kills the later actives that see a confirmed one. The
JAX package runs the rounds in a ``while_loop``; here it is a Python loop on
``active.any()``, one host sync per round (rounds = suppression-chain
depth, typically < 10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rdmnet_tpu_torch.ops.geometry import pairwise_sq_dist


def greedy_nms(nodes: torch.Tensor, nodes_mask: torch.Tensor, radius: float,
               neighbor_limit: Optional[int] = None) -> Tuple[torch.Tensor, int]:
    """nodes (B, M, 3), nodes_mask (B, M) bool -> (keep (B, M) bool, rounds).

    Strict ``<`` adjacency (a pair exactly at the radius does not suppress).
    ``neighbor_limit`` truncates each row's adjacency to its nearest entries
    (self included, ties by index) for parity with the reference's lists.
    """
    m = nodes.shape[1]
    dev = nodes.device
    sq = torch.stack([pairwise_sq_dist(n, n) for n in nodes])
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    adj = (sq < r2) & nodes_mask[:, None, :] & nodes_mask[:, :, None]
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    if neighbor_limit is not None:
        dmat = torch.where(adj | eye, torch.sqrt(sq), torch.full_like(sq, float("inf")))
        order = torch.sort(dmat, dim=2, stable=True).indices
        rank = torch.sort(order, dim=2, stable=True).indices
        adj = adj & (rank < neighbor_limit)
    adj = adj & ~eye
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=dev), diagonal=-1)
    adj_earlier = (adj & earlier).float()

    keep = torch.zeros_like(nodes_mask)
    active = nodes_mask.clone()
    rounds = 0
    while bool(active.any()):
        a = active.float()[..., None]
        has_earlier_active = (adj_earlier @ a)[..., 0] > 0.0
        confirm = active & ~has_earlier_active
        killed = (adj_earlier @ confirm.float()[..., None])[..., 0] > 0.0
        keep = keep | confirm
        active = active & ~confirm & ~killed
        rounds += 1
    return keep, rounds
