"""Train and eval steps (twin of ``rdmnet_tpu/engine/train_step.py``).

The optimizer is the JAX package's optax chain, rebuilt on ``torch.optim``:

* Adam with coupled L2 decay: ``torch.optim.Adam(weight_decay=wd)`` adds
  ``wd * p`` to the gradient before the moments, as
  ``optax.add_decayed_weights`` then ``optax.adam`` do. KPConv's kernel
  points are buffers in the port, so nothing needs a decay mask;
* the learning rate is a function of the applied-update count (optax's
  schedule count): a staircase exponential decay ("step") or linear warmup
  then cosine ("warmup_cosine");
* the non-finite guard of ``optax.apply_if_finite``: a step whose gradients
  hold a NaN or an inf is skipped and does not advance the count, unless
  more than ``MAX_CONSECUTIVE_ERRORS`` steps in a row were;
* gradient accumulation as ``optax.MultiSteps``: the running mean over
  ``grad_acc_steps`` micro-batches, one update per group. The accumulator
  restarts from zero after each group, so a group after a non-finite one
  trains again. This departs from optax on purpose: its ``(1 - emit) * acc``
  keeps a NaN, and the JAX chain skips every later group.

Data parallelism: with a process group, ``make_value_and_grad`` all-reduces
one flat buffer of the rank's gradients (SUM, then / world), the counterpart
of the psum XLA inserts under the JAX package's ``dp`` mesh, and averages
the metrics with one stacked all-reduce. Every rank then holds the same
gradients, so the non-finite guard and the update agree on every rank.
``DistributedDataParallel`` does not apply: its reducer sees only gradients
that accumulate into ``.grad``, and the step takes them with
``torch.autograd.grad``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from rdmnet_tpu_torch.config import Config
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.graph.pyramid import PairBatch
from rdmnet_tpu_torch.losses import Evaluator, OverallLoss

MAX_CONSECUTIVE_ERRORS = 100
# synchronised parts of one train step (``build`` is ``batch_to_device``)
TRAIN_STAGES = ("build", "forward", "losses", "backward", "optimizer")


def warmup_cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int,
                           eta_init: float = 0.1, eta_min: float = 0.1) -> Callable[[int], float]:
    """Linear warmup eta_init -> 1 over ``warmup_steps``, then a half cosine
    1 -> eta_min until ``total_steps``, eta_min after. Update ``count`` (0 for
    the first) takes the factor at ``count + 1``, as torch's LambdaLR in the
    reference does."""
    warmup = max(0, warmup_steps)
    normal = max(1, total_steps - warmup)

    def schedule(count: int) -> float:
        step = count + 1.0
        if step < warmup:
            factor = eta_init + (1.0 - eta_init) * step / max(warmup, 1)
        elif step > total_steps:
            factor = eta_min
        else:
            factor = eta_min + 0.5 * (1.0 - eta_min) * (
                1.0 + math.cos(math.pi * (step - warmup) / normal))
        return base_lr * factor

    return schedule


def make_schedule(cfg: Config, steps_per_epoch: int, dp_size: int = 1) -> Callable[[int], float]:
    """The learning rate as a function of the applied-update count. Under
    accumulation an epoch holds steps_per_epoch // grad_acc_steps updates, so
    "decay every lr_decay_steps epochs" stays in epochs. The base lr is
    multiplied by ``dp_size`` when ``cfg.parallel.scale_lr_by_dp``, as the
    reference does under DDP."""
    o = cfg.optim
    lr = o.lr * (dp_size if cfg.parallel.scale_lr_by_dp else 1)
    applied_per_epoch = max(1, steps_per_epoch // max(1, o.grad_acc_steps))
    if o.scheduler == "step":
        every = o.lr_decay_steps * applied_per_epoch
        return lambda count: lr * o.lr_decay ** (count // every)
    if o.scheduler == "warmup_cosine":
        return warmup_cosine_schedule(lr, o.max_epoch * applied_per_epoch,
                                      o.warmup_steps // max(1, o.grad_acc_steps),
                                      o.eta_init, o.eta_min)
    raise ValueError(f"unknown optim.scheduler {o.scheduler!r} (expected 'step' or "
                     "'warmup_cosine')")


def create_optimizer(cfg: Config, params: Sequence[torch.Tensor], steps_per_epoch: int,
                     dp_size: int = 1) -> Tuple[torch.optim.Adam, Callable[[int], float]]:
    """Adam with coupled L2 decay over ``params``, and its schedule."""
    schedule = make_schedule(cfg, steps_per_epoch, dp_size)
    # fused: one multi-tensor kernel per step over all 475 tensors at make_cfg()
    return torch.optim.Adam(params, lr=schedule(0), weight_decay=cfg.optim.weight_decay,
                            fused=True), schedule


class TrainState:
    """A model, its optimizer and the counters optax keeps in its state."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Adam,
                 schedule: Callable[[int], float], grad_acc_steps: int = 1):
        self.model = model
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.param_names: List[str] = [n for n, _ in named]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_acc_steps = max(1, grad_acc_steps)
        self.count = 0            # applied updates: the schedule's argument
        self.mini_step = 0        # micro-batches in the current group
        self.notfinite_count = 0  # skipped updates in a row
        # running mean of the current group's gradients (grad_acc_steps > 1)
        self.accumulator: Optional[List[torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-batch's gradients (in ``params`` order). Returns
        whether an update was applied. Reads one flag from the device (the
        finiteness of the update)."""
        if self.grad_acc_steps > 1:
            if self.accumulator is None:
                self.accumulator = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self.accumulator, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.grad_acc_steps:
                return False
            grads, self.accumulator = self.accumulator, None
            self.mini_step = 0
        # GradScaler's multi-tensor check: one pass over the gradients, no
        # flat copy (the scale of 1 leaves every value as it was)
        found = torch.zeros((), device=self.device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            list(grads), found, torch.ones((), device=self.device))
        finite = not bool(found)
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
            return False
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True


def create_train_state(cfg: Config, model: nn.Module, steps_per_epoch: int = 1000,
                       dp_size: int = 1) -> TrainState:
    optimizer, schedule = create_optimizer(
        cfg, [p for p in model.parameters() if p.requires_grad], steps_per_epoch, dp_size)
    return TrainState(model, optimizer, schedule, cfg.optim.grad_acc_steps)


def _check_device(state: TrainState, dev: torch.device) -> None:
    if state.device.type != dev.type:
        raise ValueError(f"the model lives on {state.device}, the step was made for {dev}")


def make_batch_loss(cfg: Config, device=None) -> Callable:
    """``batch_loss(model, batch, generator) -> (loss, metrics)``: the mean
    over the pairs of ``batch`` (a sequence of ``PairBatch``) of the training
    forward's ``OverallLoss`` terms and PIR, each pair drawing its targets
    from ``generator`` in turn. ``loss`` carries the graph for a backward;
    ``make_value_and_grad`` keeps its own per-pair backward instead, so that
    only one pair's graph is alive at a time."""
    dev = resolve_device(device)
    loss_module, evaluator = OverallLoss(cfg), Evaluator(cfg)

    def batch_loss(model: nn.Module, batch: Sequence[PairBatch], generator: torch.Generator):
        if next(model.parameters()).device.type != dev.type:
            raise ValueError(f"the model lives on {next(model.parameters()).device}, "
                             f"the loss was made for {dev}")
        scale = 1.0 / len(batch)
        means: Dict[str, torch.Tensor] = {}
        for pair in batch:
            out = model(pair, training=True, with_gt=True, generator=generator)
            losses = loss_module(out, pair)
            losses["PIR"] = evaluator(out, pair, evaling=False)["PIR"]
            for name, value in losses.items():  # summed as make_value_and_grad sums
                means[name] = means.get(name, 0.0) + value * scale
        return means["loss"], means

    return batch_loss


def make_value_and_grad(cfg: Config, device=None, group=None) -> Callable:
    """``value_and_grad(state, batch, generator, stage_hook=None) ->
    (metrics, grads)`` without the update. ``batch`` is a sequence of
    ``PairBatch`` (``batch_to_device``); the loss is the mean of the pairs'
    losses, each pair drawing its targets from ``generator`` in turn.
    ``metrics`` holds the eight loss values, PIR and ``grad_norm`` (the global
    norm), as 0-d tensors; ``grads`` follow ``state.params``. Runs on CUDA
    unless ``device`` names another device; raises without a card.

    ``group``: a data-parallel process group whose ranks each hold an equal
    share of the global batch. The gradients and metrics come back as the
    means over the ranks, the same on every rank."""
    dev = resolve_device(device)
    loss_module, evaluator = OverallLoss(cfg), Evaluator(cfg)

    def value_and_grad(state: TrainState, batch: Sequence[PairBatch],
                       generator: torch.Generator,
                       stage_hook: Optional[Callable[[str], None]] = None):
        _check_device(state, dev)
        mark = stage_hook or (lambda name: None)
        scale = 1.0 / len(batch)
        sums: Dict[str, torch.Tensor] = {}
        grads: Optional[List[torch.Tensor]] = None
        with torch.enable_grad():
            for pair in batch:
                out = state.model(pair, training=True, with_gt=True, generator=generator)
                mark("forward")
                losses = loss_module(out, pair)
                losses["PIR"] = evaluator(out, pair, evaling=False)["PIR"]
                mark("losses")
                pair_grads = torch.autograd.grad(losses["loss"] * scale, state.params,
                                                 allow_unused=True)
                pair_grads = [torch.zeros_like(p) if g is None else g
                              for p, g in zip(state.params, pair_grads)]
                grads = pair_grads if grads is None else [a + g for a, g in zip(grads, pair_grads)]
                for name, value in losses.items():
                    sums[name] = sums.get(name, 0.0) + value.detach() * scale
                mark("backward")
        # one flat copy: a few launches instead of two per tensor, and the
        # float32 sum stays pairwise on the CPU (its vector_norm of a
        # 4M-entry tensor is ~1e-4 off)
        flat = torch.cat([g.reshape(-1) for g in grads])
        if group is not None:
            flat, grads, sums = _all_reduce_mean(flat, grads, sums, group)
        sums["grad_norm"] = torch.sqrt((flat * flat).sum())
        return sums, grads

    return value_and_grad


def _all_reduce_mean(flat: torch.Tensor, grads: List[torch.Tensor],
                     metrics: Dict[str, torch.Tensor], group):
    """The means over ``group``'s ranks of the flat gradient buffer (one
    all-reduce; ``grads`` come back as views into it) and of the metrics (one
    stacked all-reduce)."""
    from rdmnet_tpu_torch.parallel.mesh import check_collective_device

    check_collective_device(flat, group)
    n = dist.get_world_size(group)
    dist.all_reduce(flat, group=group)
    flat /= n
    grads = [part.view_as(g) for part, g in zip(torch.split(flat, [g.numel() for g in grads]),
                                                grads)]
    names = list(metrics)  # one insertion order on every rank
    stacked = torch.stack([metrics[k] for k in names])
    dist.all_reduce(stacked, group=group)
    stacked /= n
    return flat, grads, dict(zip(names, stacked.unbind()))


def make_train_step(cfg: Config, device=None, group=None) -> Callable:
    """``step(state, batch, generator, stage_hook=None) -> (state, metrics)``:
    ``make_value_and_grad`` (over ``group``, see there), then
    ``state.apply_gradients``. ``stage_hook(name)`` is called after each part
    of ``TRAIN_STAGES[1:]``."""
    value_and_grad = make_value_and_grad(cfg, device, group)

    def step(state: TrainState, batch: Sequence[PairBatch], generator: torch.Generator,
             stage_hook: Optional[Callable[[str], None]] = None):
        metrics, grads = value_and_grad(state, batch, generator, stage_hook)
        state.apply_gradients(grads)
        if stage_hook is not None:
            stage_hook("optimizer")
        return state, metrics

    return step


def make_eval_step(cfg: Config, device=None, with_transform: bool = True) -> Callable:
    """``eval_step(state, batch, valid=None) -> (metrics, transforms (B, 4, 4))``:
    ``with_gt`` inference (the Sinkhorn kernel on the card), the Evaluator
    and ``dropped`` (points or voxels the pyramid's capacities cut) per pair,
    then means over the pairs; ``valid`` (B,) bool weights them when the batch
    holds more than one pair (a loader's repeated ragged tail).
    ``with_transform=False`` keeps PIR and ``dropped`` only (no IR, RRE, RTE,
    RR), as the JAX package's keyword does."""
    dev = resolve_device(device)
    evaluator = Evaluator(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Sequence[PairBatch],
                  valid: Optional[torch.Tensor] = None):
        _check_device(state, dev)
        per_pair, transforms = [], []
        for pair in batch:
            out = state.model(pair, training=False, with_gt=True)
            metrics = evaluator(out, pair, evaling=with_transform)
            metrics["dropped"] = (pair.ref.dropped.sum() + pair.src.dropped.sum()).float()
            per_pair.append(metrics)
            transforms.append(out["estimated_transform"])
        if valid is None or len(batch) == 1:
            w = torch.ones(len(batch), device=dev)
        else:
            w = torch.as_tensor(valid, device=dev).float()
        denom = torch.clamp_min(w.sum(), 1.0)
        means = {name: (torch.stack([m[name] for m in per_pair]) * w).sum() / denom
                 for name in per_pair[0]}
        return means, torch.stack(transforms)

    return eval_step
