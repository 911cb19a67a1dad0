"""Snapshots of a ``TrainState`` with epoch metadata (twin of
``rdmnet_tpu/engine/checkpoint.py``, which stores through orbax).

One directory per step, ``<directory>/<step>/``, holding ``state.pt``
(``torch.save`` of host tensors) and ``metadata.json``. A step is written
into a temporary directory and renamed into place, so a run killed while
writing never leaves a half snapshot that ``latest_step`` would pick. A
snapshot holds everything a ``TrainState`` keeps: the model's
``state_dict``, the optimizer's state keyed by parameter name, the counters
``count``, ``mini_step`` and ``notfinite_count`` (device tensors in the state,
ints in the snapshot, restored into the state's tensors in place), and the
gradient accumulator when a group is open.

Writes run on one background thread: ``save`` copies the tensors to the host
on the caller's thread and returns; readers wait for pending writes first,
and ``wait_until_finished`` raises a write's error.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from rdmnet_tpu_torch.engine.train_step import TrainState

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def state_to_host(state: TrainState) -> dict:
    """The snapshot payload: host copies of every tensor of ``state``."""
    opt = state.optimizer.state_dict()
    flat = [i for group in opt["param_groups"] for i in group["params"]]
    if len(flat) != len(state.param_names):
        raise ValueError(f"the optimizer holds {len(flat)} parameters, the state names "
                         f"{len(state.param_names)}")
    name_of = dict(zip(flat, state.param_names))
    return {
        "model": {k: _host(v) for k, v in state.model.state_dict().items()},
        "optimizer": {
            "state": {name_of[i]: {k: _host(v) if isinstance(v, torch.Tensor) else v
                                   for k, v in st.items()}
                      for i, st in opt["state"].items()},
            # the lr is a device tensor the step rewrites from the count: saved as a float
            "param_groups": [dict(g, params=[name_of[i] for i in g["params"]],
                                  lr=float(g["lr"])) for g in opt["param_groups"]],
        },
        # the device counters as ints
        **{k: int(v) for k, v in state.counters.items()},
        "accumulator": None if state.accumulator is None or state.mini_step == 0 else {
            n: _host(a) for n, a in zip(state.param_names, state.accumulator)},
    }


def load_state(state: TrainState, payload: dict) -> TrainState:
    """Load a ``state_to_host`` payload into ``state`` in place, onto its
    device. The optimizer's state is matched to the parameters by name:
    a snapshot whose parameter names differ from the model's raises."""
    state.model.load_state_dict(payload["model"], strict=True)
    saved = payload["optimizer"]
    current = state.optimizer.state_dict()["param_groups"]
    if [set(g["params"]) for g in saved["param_groups"]] != \
            [set(state.param_names[i] for i in g["params"]) for g in current]:
        raise ValueError("the snapshot's optimizer covers other parameters than the model's")
    index = {n: i for i, n in enumerate(state.param_names)}
    state.optimizer.load_state_dict({
        "state": {index[n]: st for n, st in saved["state"].items()},
        # the current groups' order, so the optimizer maps index i to params[i]
        "param_groups": [dict(s, params=g["params"])
                         for s, g in zip(saved["param_groups"], current)],
    })
    state.pin_lr()
    for k in state.COUNTERS:  # into the device tensors a captured step reads
        setattr(state, k, payload[k])
    acc = payload["accumulator"]
    if acc is not None and state.accumulator is None:
        raise ValueError("the snapshot holds an open accumulation group; the state "
                         "accumulates no gradients (grad_acc_steps 1)")
    for n, a in zip(state.param_names, state.accumulator or ()):
        if acc is None:
            a.zero_()
        else:
            a.copy_(acc[n])
    return state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending: List[Future] = []

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """Complete snapshots, ascending (temporary directories and step
        directories missing a file are not snapshots)."""
        steps = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.isdigit() and all(os.path.isfile(os.path.join(path, f))
                                      for f in (STATE_FILE, METADATA_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def save(self, step: int, state: TrainState, metadata: Optional[dict] = None):
        """Snapshot ``state`` as ``step``: the tensors are copied to the host
        now, the files are written in the background."""
        step = int(step)
        if os.path.exists(self._step_dir(step)):
            raise FileExistsError(f"snapshot step {step} already exists in {self.directory}")
        payload = state_to_host(state)
        self._pending.append(self._writer.submit(self._write, step, payload,
                                                 json.loads(json.dumps(metadata or {}))))

    def _write(self, step: int, payload: dict, metadata: dict) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METADATA_FILE), "w") as f:
            json.dump(metadata, f)
        os.rename(tmp, self._step_dir(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        self.wait_until_finished()
        return step

    def read_metadata(self, step: Optional[int] = None) -> dict:
        """The JSON metadata of a snapshot (no tensors read)."""
        with open(os.path.join(self._step_dir(self._resolve(step)), METADATA_FILE)) as f:
            return json.load(f)

    def _load(self, step: int) -> dict:
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE), map_location="cpu",
                          weights_only=True, mmap=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> Tuple[TrainState, dict]:
        """Load a snapshot into ``state`` (in place, onto its device)."""
        step = self._resolve(step)
        return load_state(state, self._load(step)), self.read_metadata(step)

    def restore_params(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` alone (host tensors), whatever the
        optimizer structure the snapshot was saved with."""
        return self._load(self._resolve(step))["model"]

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown()
