"""Process groups for data parallelism (twin of ``rdmnet_tpu/parallel/mesh.py``).

The JAX package shards the batch over a ``dp`` mesh axis and lets XLA insert
the gradient psum. The port runs one process per card (``torchrun``, or
processes started with an explicit ``init_method``): each rank holds the
whole model, its ``PairLoader`` yields its own shard, and the train step
all-reduces one flat gradient buffer (``engine/train_step.py``). That buffer
is the exchange: ``DistributedDataParallel`` does not apply, because its
reducer sees only gradients that accumulate into ``.grad`` and the step takes
them with ``torch.autograd.grad``. There is no ``shard_batch``: each rank's
loader holds its shard, as under JAX multi-host.

``make_mesh(dp, sp)`` lays the world out as a ``(dp, sp)`` grid, rank
``d * sp + s``, and returns the process groups of both axes, named as the
JAX mesh axes: ``sp`` shards one pair's large radius searches
(``parallel/sharded_search.py``). The groups come from ``new_group``
rather than ``init_device_mesh``, which binds a device type to the mesh and
so cannot lay out two gloo ranks that share one card.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           local_rank: Optional[int] = None) -> None:
    """Join the process group (once per process, before any collective).

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
    ``backend`` defaults to NCCL where a card is visible, else gloo. Under
    NCCL each rank drives card ``local_rank`` (``LOCAL_RANK``, else
    ``rank``), made current before the group starts; a rank without a card
    of its own raises. Two ranks may share one card only under gloo, named
    by the caller."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised in this process")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL rank {rank} needs card {local_rank}, and this host has "
                f"{torch.cuda.device_count()}: one card per rank (two ranks on one card "
                "only with backend='gloo')")
        torch.cuda.set_device(local_rank)
        # bound to its card: collectives and barriers need not guess it
        kwargs = {"device_id": torch.device("cuda", local_rank)}
    else:
        kwargs = {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)


def rank(group=None) -> int:
    """This process's rank in ``group`` (the world by default); 0 without a
    process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world(group=None) -> int:
    """Ranks in ``group`` (the world by default); 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0 of the world: the process that writes files."""
    return rank() == 0


class Mesh(NamedTuple):
    """The groups of a ``(dp, sp)`` layout and this rank's place in it."""

    dp: int
    sp: int
    dp_group: object   # the ranks that share this rank's sp index
    sp_group: object   # the ranks that share this rank's dp index
    dp_rank: int
    sp_rank: int


def make_mesh(dp: int = -1, sp: int = 1) -> Mesh:
    """Lay the world out as ``(dp, sp)``: rank ``d * sp + s``. ``dp = -1``
    takes ``world / sp``. A layout that does not cover the world raises.
    Every rank calls it, with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    n = dist.get_world_size()
    if dp == -1:
        dp = n // sp
    if dp < 1 or sp < 1 or dp * sp != n:
        raise ValueError(f"a (dp={dp}, sp={sp}) layout does not cover the world of {n} ranks")
    me = dist.get_rank()
    # every rank creates every group, in one order, as new_group requires
    dp_groups = [dist.new_group([d * sp + s for d in range(dp)]) for s in range(sp)]
    sp_groups = [dist.new_group([d * sp + s for s in range(sp)]) for d in range(dp)]
    return Mesh(dp, sp, dp_groups[me % sp], sp_groups[me // sp], me // sp, me % sp)


def check_collective_device(t: torch.Tensor, group=None) -> None:
    """Raise unless ``t`` can enter a collective of ``group``: under NCCL it
    lies on this rank's current card."""
    if dist.get_backend(group) == "nccl":
        here = torch.device("cuda", torch.cuda.current_device())
        if t.device != here:
            raise ValueError(f"a NCCL collective on {t.device}: this rank drives {here}")


@torch.no_grad()
def replicate(model: torch.nn.Module, group=None) -> None:
    """Broadcast the weights and buffers of ``group``'s first rank to the
    others, in place."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in list(model.parameters()) + list(model.buffers()):
        check_collective_device(t, group)
        dist.broadcast(t.data, src=src, group=group)
