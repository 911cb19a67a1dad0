"""Iteration-budget trainer (twin of ``rdmnet_tpu/engine/iter_trainer.py``;
reference geotransformer/engine/iter_based_trainer.py)."""

from __future__ import annotations

import numpy as np

from rdmnet_tpu_torch.engine.meters import to_floats
from rdmnet_tpu_torch.engine.trainer import Trainer


class CycleLoader:
    """Cycles a ``PairLoader`` without end, with shuffles that resume: pass
    ``k`` reseeds the loader with ``RandomState([seed, k])`` (an array seed:
    adjacent scalar seeds give correlated MT19937 streams), and
    ``start_iteration`` starts at the batch a stopped run reached, skipping
    the earlier items of that pass without loading them."""

    def __init__(self, loader, start_iteration: int = 0):
        self.loader = loader
        n = max(1, len(loader))
        self.pass_index = start_iteration // n
        self.skip = start_iteration % n

    def __iter__(self):
        while True:
            self.loader.rng = np.random.RandomState([self.loader.seed, self.pass_index])
            yield from self.loader.iter_from(self.skip)
            self.skip = 0
            self.pass_index += 1


def iteration_seed(seed: int, iteration: int) -> int:
    """The target generator's seed after ``iteration`` completed iterations:
    a resumed run draws a stream of its own instead of replaying the first
    (the counterpart of ``jax.random.fold_in(key, iteration)``)."""
    return int(np.random.SeedSequence([seed, iteration]).generate_state(1)[0])


class IterBasedTrainer(Trainer):
    """Trains for ``max_iterations`` steps instead of epochs: a log line every
    ``log_steps``, validation every ``val_every`` and a snapshot (metadata
    ``iteration``) every ``snapshot_every`` iterations. Data parallel with a
    ``group`` as the ``Trainer``; its steps run on the ``Trainer``'s
    programs on a card (``_train_batch``), and a resume drops them before
    the first step."""

    def __init__(self, *args, max_iterations: int = 100000, snapshot_every: int = 1000,
                 val_every: int = 1000, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_iterations = max_iterations
        self.snapshot_every = snapshot_every
        self.val_every = val_every
        self.iteration = 0

    def run(self, resume: bool = False):
        if resume:
            step = self.snapshots.latest_step()
            if step is not None:
                meta = self._restore(step)
                self.iteration = int(meta.get("iteration", step))
                self.generator.manual_seed(iteration_seed(self.target_seed, self.iteration))
                self.logger.info(f"resumed at iteration {self.iteration}")

        stream = iter(CycleLoader(self.train_loader, start_iteration=self.iteration))
        try:
            while self.iteration < self.max_iterations:
                metrics = self._train_batch(next(stream))
                self.iteration += 1
                if self.iteration % self.log_steps == 0:  # read before the next step overwrites it
                    self.logger.info(f"iter {self.iteration}/{self.max_iterations} | " + ", ".join(
                        f"{k}: {v:.4f}" for k, v in to_floats(metrics).items()))
                if self.iteration % self.val_every == 0:
                    self.validate()
                if self.iteration % self.snapshot_every == 0:
                    if self.is_main:
                        self.snapshots.save(self.iteration, self.state,
                                            metadata={"iteration": self.iteration})
                    self._barrier()
        finally:
            stream.close()  # ends the loader's prefetch thread
        self.snapshots.wait_until_finished()
        self._barrier()

