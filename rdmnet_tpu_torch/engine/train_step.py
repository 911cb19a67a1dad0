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

The guard's decision, the counters, the lr and the group's position are
device tensors, as they are inside the JAX Trainer's compiled step: a step
reads nothing back. So on the card the step, with its graph build, is
captured once as a CUDA graph and replayed (``capture_train_step``,
``capture_eval_step``): the counterparts of the JAX Trainer's jitted graph
build (``batch_to_device``), train step and eval step. The eager step and
the replay run this same code.

Data parallelism: with a process group the step is three pieces, run in
this order eagerly (``make_train_step``) and by the program
(``capture_train_step``): the gradient half (``make_gradient_half``: the
graph build, forward, losses, PIR and backward of each pair, one flat
buffer of the rank's gradients and the metrics stacked in one insertion
order), the exchange (``exchange``: one all-reduce of each buffer, the
counterpart of the psum XLA inserts under the JAX package's ``dp`` mesh)
and the update half (``_update_half``: the means over the world, the
views of ``grads``, the norm, then ``apply_gradients``). Every rank then
holds the same gradients, so the non-finite guard and the update agree on
every rank. On the card each half is a CUDA graph and the exchange runs
between the replays (``program.SplitProgram``): NCCL enqueues it on the
stream without waiting, gloo passes it through host memory. ``DistributedDataParallel``
does not apply: its reducer sees only gradients that accumulate into
``.grad``, and the step takes them with ``torch.autograd.grad``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from rdmnet_tpu_torch.config import Config, PyramidConfig
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.graph.pyramid import PairBatch, build_pair_batch
from rdmnet_tpu_torch.losses import Evaluator, OverallLoss
from rdmnet_tpu_torch.program import SplitProgram, StepProgram

MAX_CONSECUTIVE_ERRORS = 100
# synchronised parts of one train step (``build`` is ``batch_to_device``)
TRAIN_STAGES = ("build", "forward", "losses", "backward", "optimizer")


def warmup_cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int,
                           eta_init: float = 0.1, eta_min: float = 0.1) -> Callable:
    """Linear warmup eta_init -> 1 over ``warmup_steps``, then a half cosine
    1 -> eta_min until ``total_steps``, eta_min after. Update ``count`` (0 for
    the first) takes the factor at ``count + 1``, as torch's LambdaLR in the
    reference does. ``schedule(count)`` takes an int or an integer tensor and
    returns a float64 tensor on the count's device (no host read)."""
    warmup = max(0, warmup_steps)
    normal = max(1, total_steps - warmup)

    def schedule(count) -> torch.Tensor:
        step = torch.as_tensor(count).double() + 1.0
        warm = eta_init + (1.0 - eta_init) * step / max(warmup, 1)
        cosine = eta_min + 0.5 * (1.0 - eta_min) * (
            1.0 + torch.cos(math.pi * (step - warmup) / normal))
        factor = torch.where(step < warmup, warm, torch.where(step > total_steps, eta_min, cosine))
        return base_lr * factor

    return schedule


def make_schedule(cfg: Config, steps_per_epoch: int, dp_size: int = 1) -> Callable:
    """The learning rate as a function of the applied-update count (an int or
    an integer tensor; a float64 tensor on its device comes back). Under
    accumulation an epoch holds steps_per_epoch // grad_acc_steps updates, so
    "decay every lr_decay_steps epochs" stays in epochs. The base lr is
    multiplied by ``dp_size`` when ``cfg.parallel.scale_lr_by_dp``, as the
    reference does under DDP."""
    o = cfg.optim
    lr = o.lr * (dp_size if cfg.parallel.scale_lr_by_dp else 1)
    applied_per_epoch = max(1, steps_per_epoch // max(1, o.grad_acc_steps))
    if o.scheduler == "step":
        every = o.lr_decay_steps * applied_per_epoch

        def staircase(count) -> torch.Tensor:
            decays = torch.div(torch.as_tensor(count), every, rounding_mode="floor")
            return lr * o.lr_decay ** decays.double()

        return staircase
    if o.scheduler == "warmup_cosine":
        return warmup_cosine_schedule(lr, o.max_epoch * applied_per_epoch,
                                      o.warmup_steps // max(1, o.grad_acc_steps),
                                      o.eta_init, o.eta_min)
    raise ValueError(f"unknown optim.scheduler {o.scheduler!r} (expected 'step' or "
                     "'warmup_cosine')")


def create_optimizer(cfg: Config, params: Sequence[torch.Tensor], steps_per_epoch: int,
                     dp_size: int = 1) -> Tuple[torch.optim.Adam, Callable]:
    """Adam with coupled L2 decay over ``params``, and its schedule. The lr is
    a float32 tensor on the parameters' device, which ``apply_gradients``
    rewrites from the count before every step."""
    schedule = make_schedule(cfg, steps_per_epoch, dp_size)
    dev = params[0].device
    lr = schedule(torch.zeros((), dtype=torch.int64, device=dev)).float()
    # fused: one multi-tensor kernel per step over all 475 tensors at make_cfg();
    # capturable: the step may be captured in a CUDA graph (the lr and the
    # skip flag are read on the device)
    return torch.optim.Adam(params, lr=lr, weight_decay=cfg.optim.weight_decay, fused=True,
                            capturable=dev.type == "cuda"), schedule


class _Counter:
    """One of ``TrainState``'s device counters, read (a host copy) and
    written (in place) as a Python int."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, state, owner=None):
        return self if state is None else int(state.counters[self.name])

    def __set__(self, state, value):
        state.counters[self.name].fill_(int(value))


class TrainState:
    """A model, its optimizer and the counters optax keeps in its state.

    ``count`` (applied updates: the schedule's argument), ``mini_step``
    (micro-batches in the open group) and ``notfinite_count`` (skipped
    updates in a row) live on the device as int64 tensors (``counters``),
    and so do the lr and, under accumulation, the group's running mean: a
    step reads nothing back, so that it can be captured. Reading one of the
    three as an attribute copies it to the host; assigning one writes it in
    place."""

    COUNTERS = ("count", "mini_step", "notfinite_count")
    count, mini_step, notfinite_count = _Counter(), _Counter(), _Counter()

    def __init__(self, model: nn.Module, optimizer: torch.optim.Adam,
                 schedule: Callable, grad_acc_steps: int = 1):
        self.model = model
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.param_names: List[str] = [n for n, _ in named]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_acc_steps = max(1, grad_acc_steps)
        dev = self.device
        self.counters = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in self.COUNTERS}
        self.lr = optimizer.param_groups[0]["lr"]
        self._one = torch.ones((), device=dev)
        # running mean of the current group's gradients (grad_acc_steps > 1),
        # views of one flat buffer so that the restart after a group is one fill
        self.accumulator: Optional[List[torch.Tensor]] = None
        if self.grad_acc_steps > 1:
            flat = torch.zeros(sum(p.numel() for p in self.params), device=dev)
            self.accumulator = [part.view_as(p) for part, p in
                                zip(torch.split(flat, [p.numel() for p in self.params]),
                                    self.params)]
            self._flat_accumulator = flat

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def pin_lr(self) -> None:
        """Point every param group at ``self.lr`` again (a loaded optimizer
        state carries its own lr; a captured step reads this tensor)."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
            group["capturable"] = self.device.type == "cuda"

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Take one micro-batch's gradients (in ``params`` order). Returns a
        0-d bool tensor: whether an update was applied. Reads nothing from the
        device: the guard's decision is a flag that fused Adam honours (it
        skips the update and takes its ``step`` back), the lr is computed
        from ``count`` on the device, and the group's position is a tensor,
        so a captured step replays exactly this code."""
        c = self.counters
        emit = None
        if self.grad_acc_steps > 1:
            n = c["mini_step"] + 1
            for acc, g in zip(self.accumulator, grads):
                acc.add_((g - acc) / n)
            emit = n == self.grad_acc_steps
            grads = self.accumulator
        # GradScaler's multi-tensor check: one pass over the gradients, no
        # flat copy (the scale of 1 leaves every value as it was)
        found = torch.zeros((), device=self.device)
        torch._amp_foreach_non_finite_check_and_unscale_(list(grads), found, self._one)
        bad = found > 0
        notfinite = torch.where(bad, c["notfinite_count"] + 1, 0)
        if emit is not None:
            notfinite = torch.where(emit, notfinite, c["notfinite_count"])
        skip = bad & (notfinite <= MAX_CONSECUTIVE_ERRORS)
        if emit is not None:
            skip = skip | ~emit
        c["notfinite_count"].copy_(notfinite)
        self.lr.copy_(self.schedule(c["count"]))
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.found_inf = skip.float()
        self.optimizer.step()
        self.optimizer.found_inf = None
        for p in self.params:
            p.grad = None
        c["count"].add_((~skip).long())
        if emit is not None:
            c["mini_step"].copy_(torch.where(emit, 0, n))
            # the group's restart from zero: a non-finite group leaves no NaN behind
            self._flat_accumulator.masked_fill_(emit, 0.0)
        return ~skip


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


def _pair_gradients(cfg: Config) -> Callable:
    """``gradients(state, batch, generator, mark) -> (sums, grads)``: each
    pair's forward, losses, PIR and backward in turn; ``sums`` the metrics'
    means over the pairs (in the losses' insertion order), ``grads`` the mean
    gradient, one tensor a parameter."""
    loss_module, evaluator = OverallLoss(cfg), Evaluator(cfg)

    def gradients(state: TrainState, batch: Sequence[PairBatch], generator: torch.Generator,
                  mark: Callable[[str], None]):
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
        return sums, grads

    return gradients


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
    means over the ranks, the same on every rank: the gradient half, the
    exchange and the means of the update half (module docstring)."""
    dev = resolve_device(device)
    if group is not None:
        gradient_half = make_gradient_half(cfg, dev)

        def value_and_grad_dp(state: TrainState, batch: Sequence[PairBatch],
                              generator: torch.Generator,
                              stage_hook: Optional[Callable[[str], None]] = None):
            flat, stacked, names = gradient_half(state, batch, generator, stage_hook)
            exchange(flat, stacked, group)
            return _means(state, flat, stacked, names, dist.get_world_size(group))

        return value_and_grad_dp
    gradients = _pair_gradients(cfg)

    def value_and_grad(state: TrainState, batch: Sequence[PairBatch],
                       generator: torch.Generator,
                       stage_hook: Optional[Callable[[str], None]] = None):
        _check_device(state, dev)
        sums, grads = gradients(state, batch, generator, stage_hook or (lambda name: None))
        # one flat copy: a few launches instead of two per tensor, and the
        # float32 sum stays pairwise on the CPU (its vector_norm of a
        # 4M-entry tensor is ~1e-4 off)
        flat = torch.cat([g.reshape(-1) for g in grads])
        sums["grad_norm"] = torch.sqrt((flat * flat).sum())
        return sums, grads

    return value_and_grad


def make_gradient_half(cfg: Config, device=None) -> Callable:
    """The data-parallel step's gradient half: ``gradients(state, batch,
    generator, stage_hook=None) -> (flat, stacked, names)``, the rank's mean
    gradient over its pairs as one flat float32 buffer in ``state.params``
    order and its metrics (the eight losses and PIR) stacked in the order of
    ``names``, both for ``exchange`` to sum in place. Reads nothing back."""
    dev = resolve_device(device)
    gradients = _pair_gradients(cfg)

    def gradient_half(state: TrainState, batch: Sequence[PairBatch], generator: torch.Generator,
                      stage_hook: Optional[Callable[[str], None]] = None):
        _check_device(state, dev)
        sums, grads = gradients(state, batch, generator, stage_hook or (lambda name: None))
        flat = torch.cat([g.reshape(-1) for g in grads])
        names = list(sums)  # one insertion order on every rank
        return flat, torch.stack([sums[k] for k in names]), names

    return gradient_half


def exchange(flat: torch.Tensor, stacked: torch.Tensor, group) -> None:
    """The data-parallel exchange: ``flat`` and ``stacked`` summed over
    ``group``'s ranks in place, one all-reduce each, on the current stream
    (NCCL) or through host memory (gloo)."""
    from rdmnet_tpu_torch.parallel.mesh import check_collective_device

    check_collective_device(flat, group)
    dist.all_reduce(flat, group=group)
    dist.all_reduce(stacked, group=group)


def _means(state: TrainState, flat: torch.Tensor, stacked: torch.Tensor, names: List[str],
           world: int):
    """The exchanged sums -> (metrics with ``grad_norm``, grads): both means
    over the ``world`` ranks in place, ``grads`` views into ``flat``."""
    flat /= world
    stacked /= world
    grads = [part.view_as(p) for part, p in zip(torch.split(flat, [p.numel() for p in state.params]),
                                                state.params)]
    metrics = dict(zip(names, stacked.unbind()))
    metrics["grad_norm"] = torch.sqrt((flat * flat).sum())
    return metrics, grads


def _update_half(state: TrainState, mid, world: int) -> Dict[str, torch.Tensor]:
    """The program's update half on ``mid`` (the gradient half's outputs,
    exchanged): ``_means``, then ``state.apply_gradients``, as
    ``make_train_step`` runs them over a group. Returns the metrics."""
    metrics, grads = _means(state, *mid, world)
    state.apply_gradients(grads)
    return metrics


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
        else:  # a host mask is copied without a host sync; a card mask is read in place
            w = torch.as_tensor(valid).to(dev, non_blocking=True).float()
        denom = torch.clamp_min(w.sum(), 1.0)
        means = {name: (torch.stack([m[name] for m in per_pair]) * w).sum() / denom
                 for name in per_pair[0]}
        return means, torch.stack(transforms)

    return eval_step


# ------------------------------------------------------------------ batches

BATCH_INPUTS = {"ref_points": torch.float32, "ref_counts": torch.int32,
                "src_points": torch.float32, "src_counts": torch.int32,
                "transform": torch.float32, "ref_dropped": torch.int32,
                "src_dropped": torch.int32}
_NUMPY = {torch.float32: np.float32, torch.int32: np.int32}


def batch_inputs(np_batch: Mapping) -> Dict[str, np.ndarray]:
    """The arrays of a host batch of padded pairs that a step reads, in
    ``BATCH_INPUTS``'s dtypes: ``ref_points``/``src_points`` (B, cap_0, 3),
    ``ref_counts``/``src_counts`` (B,), ``transform`` (B, 4, 4) and the host
    truncation counts ``ref_dropped``/``src_dropped`` (B,), zeros where the
    batch has none."""
    bsz = len(np_batch["ref_points"])
    return {key: np.asarray(np_batch[key] if key in np_batch else np.zeros(bsz), _NUMPY[dtype])
            for key, dtype in BATCH_INPUTS.items()}


def build_batch(inputs: Mapping[str, torch.Tensor], spec: PyramidConfig) -> List[PairBatch]:
    """Device tensors of ``BATCH_INPUTS`` (B, ...) -> one ``PairBatch`` per
    pair, its pyramid built on their device (the radius-kNN kernel on the
    card). Reads nothing back: the truncation counts stay tensors, so a
    captured step can take them as static inputs."""
    t = inputs
    return [build_pair_batch(t["ref_points"][b], t["ref_counts"][b], t["src_points"][b],
                             t["src_counts"][b], t["transform"][b], spec,
                             ref_dropped0=t["ref_dropped"][b], src_dropped0=t["src_dropped"][b])
            for b in range(t["ref_points"].shape[0])]


# ----------------------------------------------------------------- programs

def _program_device(what: str, state: TrainState, device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"capture_{what}_step: a CUDA graph needs a CUDA device, got {dev}; "
                         f"the {what} step runs eagerly there")
    _check_device(state, dev)
    return state.device


def _input_shapes(cfg: Config, batch_size: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    cap = cfg.pyramid.caps[0]
    per_pair = {"ref_points": (cap, 3), "src_points": (cap, 3), "transform": (4, 4)}
    return {k: ((batch_size,) + per_pair.get(k, ()), dtype) for k, dtype in BATCH_INPUTS.items()}


def capture_train_step(state: TrainState, cfg: Config, batch_size: int,
                       generator: torch.Generator, device=None, group=None) -> StepProgram:
    """``make_train_step``'s step with its graph build as a program on the
    card (``StepProgram``): ``program(np_batch) -> metrics`` takes a host
    batch of ``batch_size`` pairs padded to ``cfg.pyramid.caps[0]``
    (``batch_inputs``), builds its pyramids, runs the forward, the losses,
    the backward, the flat gradient and its norm, the non-finite guard and
    fused Adam, and returns ``make_train_step``'s metrics. The targets are
    drawn from ``generator`` (a CUDA generator, registered with the graph:
    each replay draws what the eager step would have drawn), so the eager
    warm-up calls and the replays after them give the steps an eager loop
    gives. Gradient accumulation runs inside: one program serves
    every micro-batch of a group. Raises on a CPU device, where the step
    runs eagerly.

    With a data-parallel ``group`` the program is a ``SplitProgram``: the
    gradient half with the graph build and the update half, each a graph,
    the exchange between their replays (one exchange a micro-batch), as
    ``make_train_step(cfg, device, group)`` runs them."""
    dev = _program_device("train", state, device)
    shapes = _input_shapes(cfg, batch_size)
    if group is not None:
        gradient_half = make_gradient_half(cfg, dev)
        world = dist.get_world_size(group)
        return SplitProgram(
            "capture_train_step",
            lambda static: gradient_half(state, build_batch(static, cfg.pyramid), generator),
            lambda mid: exchange(mid[0], mid[1], group),
            lambda mid: _update_half(state, mid, world),
            batch_inputs, shapes, dev, generator)
    value_and_grad = make_value_and_grad(cfg, dev)

    def body(static):
        metrics, grads = value_and_grad(state, build_batch(static, cfg.pyramid), generator)
        state.apply_gradients(grads)
        return metrics

    return StepProgram("capture_train_step", body, batch_inputs, shapes, dev, generator)


def capture_eval_step(state: TrainState, cfg: Config, batch_size: int, device=None,
                      with_transform: bool = True) -> StepProgram:
    """``make_eval_step``'s step with its graph build as a program on the
    card (``StepProgram``): ``program(np_batch, valid=None) -> (metrics,
    transforms)`` over a host batch of ``batch_size`` pairs; ``valid`` (B,)
    bool weights the pairs (all of them when None). Raises on a CPU device,
    where the step runs eagerly."""
    dev = _program_device("eval", state, device)
    eval_step = make_eval_step(cfg, dev, with_transform)
    shapes = dict(_input_shapes(cfg, batch_size), valid=((batch_size,), torch.bool))

    def stage(np_batch, valid=None):
        return dict(batch_inputs(np_batch),
                    valid=np.ones(batch_size, bool) if valid is None else np.asarray(valid, bool))

    def body(static):
        return eval_step(state, build_batch(static, cfg.pyramid), static["valid"])

    return StepProgram("capture_eval_step", body, stage, shapes, dev)
