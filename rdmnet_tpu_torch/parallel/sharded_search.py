"""Query-sharded radius search (twin of ``rdmnet_tpu/parallel/sharded_search.py``).

The graph build's large searches split by query rows over an ``sp`` process
group: every rank holds the whole support (a few MB a level), searches a
contiguous shard of the queries on its card with the radius-kNN route of
``ops/radius_search.py``, and one ``all_gather`` hands every rank the whole
table. This is latency scaling for one pair, orthogonal to ``dp``.

Shards start at multiples of ``chunk_size``: the queries are padded to
``world x rows`` with ``rows`` a multiple of the chunk, so each shard's
chunks are the unsharded search's chunks (plus wholly padded ones) and see
the same banded windows. The tables therefore equal the unsharded ones bit
for bit, banded or not. The JAX package pads only to a multiple of the
device count, so its banded shards may cut a chunk.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from rdmnet_tpu_torch.ops.grid_subsample import PAD_COORD
from rdmnet_tpu_torch.ops.radius_search import radius_knn, radius_knn_banded
from rdmnet_tpu_torch.parallel.mesh import check_collective_device


def shard_rows(num_queries: int, world: int, chunk_size: int) -> int:
    """Query rows per shard: the fewest whole chunks that cover the queries
    over ``world`` shards."""
    return max(1, -(-num_queries // (world * chunk_size))) * chunk_size


def sharded_radius_knn(q_points: torch.Tensor, s_points: torch.Tensor, s_count: torch.Tensor,
                       radius: float, k: int, group, q_count: Optional[torch.Tensor] = None,
                       cell: Optional[float] = None, band_cap: Optional[int] = None,
                       chunk_size: int = 512, return_overflow: bool = False):
    """Radius kNN with the queries sharded over ``group``.

    The arguments follow ``ops.radius_search.radius_knn`` /
    ``radius_knn_banded``: one cloud (``(Q, 3)``, ``s_count`` ``()``) or a
    batch (``(B, Q, 3)``, ``(B,)``), the same on every rank. ``cell`` with
    ``band_cap`` takes the banded search per shard. Returns the whole
    ``(.., Q, k)`` int32 table on every rank and, with ``return_overflow``,
    the band overflow summed over the shards (0 unbanded)."""
    single = q_points.dim() == 2
    q = q_points[None] if single else q_points
    s = s_points[None] if single else s_points
    bsz, nq, _ = q.shape
    cnt = s_count.reshape(bsz)
    qc = (torch.full((bsz,), nq, dtype=torch.int32, device=q.device) if q_count is None
          else q_count.reshape(bsz).to(torch.int32))
    n, me = dist.get_world_size(group), dist.get_rank(group)
    rows = shard_rows(nq, n, chunk_size)
    lo = me * rows
    shard = torch.full((bsz, rows, 3), PAD_COORD, dtype=q.dtype, device=q.device)
    take = max(0, min(nq - lo, rows))
    shard[:, :take] = q[:, lo:lo + take]
    # the shard's valid queries: the rows of [lo, lo + rows) below q_count
    shard_count = torch.clamp(qc - lo, 0, rows)
    if band_cap is not None and cell is not None:
        out, overflow = radius_knn_banded(shard, s, cnt, radius, k, cell=cell, band_cap=band_cap,
                                          q_count=shard_count, chunk_size=chunk_size)
    else:
        out = radius_knn(shard, s, cnt, radius, k)
        overflow = torch.zeros(bsz, dtype=torch.int32, device=q.device)
    check_collective_device(out, group)
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(), group=group)
    table = torch.cat(parts, dim=1)[:, :nq]
    if single:
        table = table[0]
    if not return_overflow:
        return table
    overflow = overflow.to(torch.int32).contiguous()
    dist.all_reduce(overflow, group=group)
    return table, (overflow[0] if single else overflow)
