"""Epoch-based trainer (twin of ``rdmnet_tpu/engine/trainer.py``; reference
geotransformer/engine/epoch_based_trainer.py:16-198, base_trainer.py:32-259):
host batches to pyramids on the device, the train step, validation, rolling
snapshots, the best-by-validation snapshot, resume, ``metrics.jsonl``.

Data parallel with a process group: one rank per card, each on its own
loader shard, the gradients all-reduced in the step (``train_step.py``:
between the two graphs of its program on the card).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from rdmnet_tpu_torch.config import Config, PyramidConfig
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager
from rdmnet_tpu_torch.engine.logger import create_logger
from rdmnet_tpu_torch.engine.meters import SummaryBoard, Timer, to_floats
from rdmnet_tpu_torch.engine.train_step import (batch_inputs, build_batch, capture_eval_step,
                                                capture_train_step, create_train_state,
                                                make_eval_step, make_train_step)
from rdmnet_tpu_torch.graph.pyramid import PairBatch
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.parallel.mesh import is_main, replicate
from rdmnet_tpu_torch.parallel.mesh import rank as group_rank
from rdmnet_tpu_torch.parallel.mesh import world as group_world


@torch.no_grad()
def batch_to_device(np_batch: Mapping, spec: PyramidConfig, device=None) -> List[PairBatch]:
    """A host batch of padded pairs -> one ``PairBatch`` per pair, its
    pyramid built on the device (the radius-kNN kernel on the card).

    ``np_batch`` holds ``ref_points``/``src_points`` (B, cap_0, 3),
    ``ref_counts``/``src_counts`` (B,), ``transform`` (B, 4, 4) and optional
    ``ref_dropped``/``src_dropped`` (B,) host truncation counts. Runs on CUDA
    unless ``device`` names another device; raises without a card."""
    dev = resolve_device(device)
    return build_batch({k: torch.tensor(v, device=dev) for k, v in batch_inputs(np_batch).items()},
                       spec)


class Trainer:
    """Trains ``cfg`` on ``train_loader`` for ``cfg.optim.max_epoch`` epochs
    on ``device`` (CUDA unless told otherwise), validating on ``val_loader``
    after each epoch. Writes ``config.json``, ``logs/train.log``,
    ``metrics.jsonl`` (one train and one val record per epoch), a snapshot
    per epoch in ``snapshots/`` (the newest ``keep_snapshots``, all if None)
    and the best one by validation (higher RR, then lower RRE, then lower RTE)
    in ``snapshots_best/``.

    The weights are drawn from ``cfg.seed``; the target sample of each train
    step from a generator seeded with ``cfg.seed + 1``. ``resume`` keeps the
    JAX package's semantics, two quirks included: the target generator
    restarts from ``cfg.seed + 1`` and the loaders' shuffle (with their
    datasets' draws) from their seeds, rather than continuing where the
    interrupted run stood.

    On a card the train and eval steps, each with its graph build, run as
    captured programs (``capture_train_step``, ``capture_eval_step``: CUDA
    graphs made at the first batch of each, after their eager warm-up
    steps), with or without a process group: under a group the train
    program is two graphs with the gradient exchange between their replays
    (``program.SplitProgram``), and the validation sums cross the ranks
    after the loop. A failed capture raises. The CPU steps eagerly. Each
    step's metrics are copied out of the step's outputs on the device, and
    a log window's are read back in one copy at its end. Restoring a
    snapshot drops both programs (the restored optimizer holds new moment
    tensors): they are captured anew.

    ``epoch_timings`` gets one record per training epoch: its wall seconds,
    the seconds the loop waited on the loader, the steps and the windowed
    steps/s of each log line; ``val_timings`` one per validation: its
    seconds and pairs.

    ``group``: the data-parallel process group (``cfg.parallel.dp`` ranks,
    or any number with dp = -1), whose rank r holds shard r of each loader
    (``PairLoader(num_hosts=world, host_id=r)``). Rank 0's weights are
    broadcast after the initialisation, ``resume`` and ``warm_start``; the
    lr is multiplied by the world size when ``cfg.parallel.scale_lr_by_dp``;
    rank r draws its targets from a generator of its own; validation means
    cover every rank's pairs once. Rank 0 of the world alone writes files,
    each write followed by a barrier."""

    def __init__(self, cfg: Config, train_loader, val_loader=None, output_dir: str = "output",
                 log_steps: int = 10, keep_snapshots: Optional[int] = None, device=None,
                 group=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.output_dir = output_dir
        self.log_steps = log_steps
        self.group = group
        self.rank, self.dp = check_dp_layout(cfg, group, train_loader, val_loader)
        self.is_main = group is None or is_main()
        self.logger = create_logger(os.path.join(output_dir, "logs", "train.log")
                                    if self.is_main else None)
        if not self.is_main:
            self.logger.setLevel(logging.WARNING)
        self.snapshots = CheckpointManager(os.path.join(output_dir, "snapshots"),
                                           max_to_keep=keep_snapshots)
        self.best_snapshots = CheckpointManager(os.path.join(output_dir, "snapshots_best"),
                                                max_to_keep=1)
        self._best_score = None
        if self.is_main:
            with open(os.path.join(output_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=1, default=str)
        self._barrier()

        # the first batch, read as the JAX Trainer reads it to initialise: the
        # same seeds then give both packages the same epochs
        example = train_loader.peek()
        if example["ref_points"].shape[1] != cfg.pyramid.caps[0]:
            raise ValueError(f"the train loader pads to {example['ref_points'].shape[1]} points, "
                             f"the pyramid's level 0 holds {cfg.pyramid.caps[0]}")
        model = RDMNet(cfg, device=self.device, generator=torch.Generator().manual_seed(cfg.seed))
        self.state = create_train_state(cfg, model, steps_per_epoch=max(len(train_loader), 1),
                                        dp_size=self.dp)
        self._replicate()
        self.train_step = make_train_step(cfg, self.device, group)
        self.eval_step = make_eval_step(cfg, self.device)
        # on a card each step runs as a captured program, made at its first
        # batch; the CPU steps eagerly
        self.use_programs = self.device.type == "cuda"
        self.train_program = self.eval_program = None
        self.epoch = 0
        self.target_seed = rank_seed(cfg.seed + 1, self.rank)
        self.generator = torch.Generator(device=self.device).manual_seed(self.target_seed)
        self.epoch_timings: List[dict] = []
        self.val_timings: List[dict] = []

    def resume(self):
        step = self.snapshots.latest_step()
        if step is None:
            self.logger.info("no snapshot found; training from scratch")
            return
        meta = self._restore(step)
        self.epoch = int(meta.get("epoch", step))
        try:
            self._best_score = tuple(self.best_snapshots.read_metadata()["score"])
        except (FileNotFoundError, KeyError):
            pass
        self.logger.info(f"resumed from snapshot step={step} epoch={self.epoch}")

    def warm_start(self, snapshot_dir: str, step: Optional[int] = None):
        """Load the weights alone from another run's snapshot (curriculum
        phases, fine-tuning): the optimizer, the epoch counter and the
        schedule stay fresh, whatever the source run's optimizer was."""
        params = CheckpointManager(snapshot_dir).restore_params(step)
        self.state.model.load_state_dict(params, strict=True)
        self._replicate()
        self.logger.info(f"warm-started params from {snapshot_dir}")

    def _restore(self, step: int) -> dict:
        """The state of snapshot ``step`` (rank 0's weights on every rank);
        returns its metadata. Drops both programs: the restored optimizer
        holds new moment tensors, so they are captured anew."""
        self.state, meta = self.snapshots.restore(self.state, step)
        self.train_program = self.eval_program = None
        self._replicate()
        return meta

    def _train_batch(self, np_batch: Mapping, built: Callable[[], None] = lambda: None) -> dict:
        """One train step on a host batch: the program's replay on a card,
        the eager step elsewhere. ``built()`` is called once the batch's
        graph is built: after ``batch_to_device`` eagerly, before the replay
        on a program (which builds inside). Returns the step's metrics (0-d
        device tensors), which the next step overwrites: consume them
        first."""
        if not self.use_programs:
            batch = batch_to_device(np_batch, self.cfg.pyramid, self.device)
            built()
            self.state, metrics = self.train_step(self.state, batch, self.generator)
            return metrics
        if self.train_program is None:
            self.train_program = capture_train_step(
                self.state, self.cfg, len(np_batch["ref_points"]), self.generator, self.device,
                self.group)
        built()  # the graph build runs inside the program
        return self.train_program(np_batch)

    def _replicate(self):
        if self.group is not None:
            replicate(self.state.model, self.group)

    def _barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def train_epoch(self) -> dict:
        board = SummaryBoard(last_n=self.log_steps)
        timer = Timer()
        # each step's metrics copied into one tensor on the device (a replayed
        # program overwrites its outputs), the window read in one copy at its end
        names, pending = [], []
        rates = []
        steps, wait = 0, 0.0

        def flush():
            if pending:
                for row in torch.stack(pending).tolist():
                    board.update_from_dict(dict(zip(names, row)))
            pending.clear()

        loader = iter(self.train_loader)
        t_epoch = t_win = time.perf_counter()
        timer.tic()
        while True:
            t0 = time.perf_counter()
            np_batch = next(loader, None)
            wait += time.perf_counter() - t0
            if np_batch is None:
                break
            metrics = self._train_batch(np_batch, timer.record_prepare)
            names[:] = list(metrics)
            pending.append(torch.stack([metrics[k].float() for k in names]))
            timer.record_process()
            steps += 1
            if steps % self.log_steps == 0:
                flush()
                rate = self.log_steps / max(time.perf_counter() - t_win, 1e-9)
                rates.append(rate)
                t_win = time.perf_counter()
                self.logger.info(
                    f"epoch {self.epoch} step {steps}/{len(self.train_loader)} "
                    f"| {board.format()} | prep {timer.prepare_time():.3f}s "
                    f"proc {timer.process_time():.3f}s | {rate:.2f} steps/s")
        flush()
        self.epoch_timings.append({"epoch": self.epoch, "seconds": time.perf_counter() - t_epoch,
                                   "loader_wait_s": wait, "steps": steps,
                                   "window_steps_per_s": rates})
        return board.summary()

    def validate(self) -> dict:
        """Means over the validation pairs: each batch's mean weighted by its
        valid pairs, so a ragged tail's repeats count once."""
        if self.val_loader is None:
            return {}
        sums: dict = {}
        denom = 0.0
        t0 = time.perf_counter()
        for b, np_batch in enumerate(self.val_loader):
            bsz = len(np_batch["ref_points"])
            valid = np_batch.get("batch_valid")
            if self.group is not None:
                # a shard's repeats of the head count on the rank that owns it
                valid = (np.ones(bsz, bool) if valid is None else valid) \
                    & ~self.val_loader.repeated(b)
            if self.use_programs:
                if self.eval_program is None:
                    self.eval_program = capture_eval_step(self.state, self.cfg, bsz, self.device)
                metrics, _ = self.eval_program(np_batch, valid)
            else:
                batch = batch_to_device(np_batch, self.cfg.pyramid, self.device)
                metrics, _ = self.eval_step(
                    self.state, batch, None if valid is None else torch.as_tensor(valid))
            n_valid = float(np.sum(valid)) if valid is not None else float(bsz)
            for k, v in to_floats(metrics).items():
                sums[k] = sums.get(k, 0.0) + v * n_valid
            denom += n_valid
        if self.group is not None:
            names = sorted(sums)  # the same keys on every rank
            total = torch.tensor([sums[k] for k in names] + [denom], dtype=torch.float64,
                                 device=self.device)
            dist.all_reduce(total, group=self.group)
            sums, denom = dict(zip(names, total[:-1].tolist())), float(total[-1])
        self.val_timings.append({"epoch": self.epoch, "seconds": time.perf_counter() - t0,
                                 "pairs": denom})
        summary = {k: v / max(denom, 1.0) for k, v in sums.items()}
        line = ", ".join(f"{k}: {v:.4f}" for k, v in sorted(summary.items()))
        self.logger.info(f"val epoch {self.epoch} | {line}")
        return summary

    @staticmethod
    def _val_score(summary: dict):
        """Best-snapshot order: higher RR, then lower RRE, then lower RTE."""
        if "RR" not in summary:
            return None
        return (float(summary["RR"]), -float(summary.get("RRE", np.inf)),
                -float(summary.get("RTE", np.inf)))

    def _maybe_save_best(self, val_summary: dict):
        score = self._val_score(val_summary)
        if score is None:
            return
        if self._best_score is not None and tuple(score) <= tuple(self._best_score):
            return
        self._best_score = score
        if self.is_main:
            self.best_snapshots.save(
                self.epoch, self.state,
                metadata={"epoch": self.epoch, "score": list(score),
                          **{k: float(v) for k, v in val_summary.items()
                             if isinstance(v, (int, float))}})
        self._barrier()
        self.logger.info(f"new best val snapshot at epoch {self.epoch} "
                         f"(RR {score[0]:.4f}, RRE {-score[1]:.4f}, RTE {-score[2]:.4f})")

    def _write_metrics(self, phase: str, summary: dict):
        """Append one record to ``metrics.jsonl`` (rank 0)."""
        if self.is_main:
            with open(os.path.join(self.output_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps({"phase": phase, "epoch": self.epoch, **summary}) + "\n")
        self._barrier()

    def run(self, resume: bool = False):
        if resume:
            self.resume()
        while self.epoch < self.cfg.optim.max_epoch:
            t0 = time.perf_counter()
            train_summary = self.train_epoch()
            self._write_metrics("train", train_summary)
            val_summary = self.validate()
            if val_summary:
                self._write_metrics("val", val_summary)
            self.epoch += 1
            if self.is_main:  # the host copy here, the write on the writer thread
                self.snapshots.save(self.epoch, self.state,
                                    metadata={"epoch": self.epoch,
                                              "loss": float(train_summary.get("loss", np.nan))})
            self._barrier()
            if val_summary:
                self._maybe_save_best(val_summary)
            t = self.epoch_timings[-1]
            self.logger.info(f"epoch {self.epoch} done in {time.perf_counter() - t0:.1f}s "
                             f"({t['steps']} steps, {t['loader_wait_s']:.3f}s waiting on the "
                             "loader); snapshot saved")
        self.snapshots.wait_until_finished()
        self.best_snapshots.wait_until_finished()
        self._barrier()  # every rank returns with the snapshots on disk


def rank_seed(seed: int, rank: int) -> int:
    """The target generator's seed on data-parallel rank ``rank``: ``seed``
    on rank 0 (a one-process run's), a stream of its own on the others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def check_dp_layout(cfg: Config, group, *loaders):
    """(rank, world) of ``group``, checked against ``cfg.parallel.dp`` and the
    loaders' shards: a data-parallel config without a group, a group of
    another size, or a loader that is not this rank's shard raises."""
    dp = cfg.parallel.dp
    if group is None:
        if dp != 1:
            raise RuntimeError(f"parallel.dp={dp} needs a process group (initialize_distributed, "
                               "then Trainer(..., group=...)); none was given")
        return 0, 1
    rank, world = group_rank(group), group_world(group)
    if dp not in (-1, world):
        raise ValueError(f"parallel.dp={dp} disagrees with the group's {world} ranks")
    for loader in loaders:
        if loader is not None and (getattr(loader, "num_hosts", 1), getattr(loader, "host_id", 0)) \
                != (world, rank):
            raise ValueError(f"rank {rank} of {world} needs the loader shard "
                             f"num_hosts={world}, host_id={rank}")
    return rank, world
