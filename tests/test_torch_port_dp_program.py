"""The data-parallel train step split at its gradient exchange, on the CPU.

On the card a Trainer with a process group replays its train step as two
CUDA graphs with the exchange between them (``program.SplitProgram``, made
by ``engine.train_step.capture_train_step(..., group=...)``): the gradient
half (graph build, forward, losses, PIR, backward, the flat gradient and the
stacked metrics), the exchange (two all-reduces) and the update half (the
means, the norm, the guard, the counters, the schedule, ``MultiSteps`` and
Adam). The eager ``make_train_step(cfg, device, group)`` runs the same three
pieces. A CUDA graph cannot run here, so these tests hold what the CPU can
show, on two ranks spawned on gloo at ``make_tiny_cfg()`` (one thread each,
no JAX in them; JAX runs in the parent's fixture of
``test_torch_port_parallel.py``):

* each half, run under the ``TorchDispatchMode`` of
  ``test_torch_port_train_program.py``, reads nothing back and holds no
  collective; the exchange holds the two all-reduces and nothing else
  (grad_acc_steps 1 and 2);
* the pieces over 3 steps (4 at grad_acc_steps 2: two groups), rank 1's
  ground truth NaN at step 2: both ranks skip that update; weights, Adam's
  moments and steps and the counters bit-equal across ranks after every
  step and equal to ``make_train_step``'s over the group; step 1's losses
  and gradients within the bounds of ``test_dp_losses_match_jax_two_pair_step``
  and ``test_dp_gradients_match_jax_two_pair_step`` of JAX's two-pair step,
  from JAX's weights (``params_from_jax``);
* the dp capture and ``SplitProgram`` refuse a CPU device;
* a Trainer and an ``IterBasedTrainer`` on a program that overwrites its
  outputs each call log each step's own values, and a resumed
  ``IterBasedTrainer`` captures anew instead of replaying a program made
  before the restore.
"""

import dataclasses
import hashlib
import os
import re
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_port_parallel import LOSSES, one_process  # noqa: F401 (a fixture)
from test_torch_port_train_program import CARD_KERNELS, HostReads

from rdmnet_tpu_torch.config import make_tiny_cfg

WORLD = 2
NAN_STEP = 1                  # the step (from 0) whose ground truth is NaN on rank 1
STEPS = {1: 3, 2: 4}          # steps of each run by grad_acc_steps: at 2, two groups


def _cfg(grad_acc):
    cfg = make_tiny_cfg()
    return dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=grad_acc))


def _digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _state_digests(state) -> dict:
    """Every tensor a train step writes, one digest a kind."""
    opt = [state.optimizer.state[p] for p in state.params if p in state.optimizer.state]
    return {"weights": _digest(state.params),
            "exp_avg": _digest(s["exp_avg"] for s in opt),
            "exp_avg_sq": _digest(s["exp_avg_sq"] for s in opt),
            "adam step": _digest(s["step"] for s in opt),
            "counters": {k: int(v) for k, v in state.counters.items()},
            "lr": _digest([state.lr])}


# ------------------------------------------------------------------ ranks

class Watch(HostReads):
    """``HostReads`` that records instead of raising: the ops that read a
    value back, and the collectives."""

    def __init__(self):
        super().__init__()
        self.reads, self.collectives = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            self.collectives.append(str(func.overloadpacket))
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        except AssertionError as e:
            self.reads.append(str(e))
            return func(*args, **(kwargs or {}))


def _watched(fn, *args):
    """``fn(*args)`` under a ``Watch``, the card's kernels' plain versions
    excepted as ``test_torch_port_train_program.py`` excepts them: (result,
    reads, collectives)."""
    watch = Watch()
    saved = {}
    for (module, name), _ in CARD_KERNELS.items():
        fn_ = saved[(module, name)] = getattr(module, name)

        def paused(*a, _fn=fn_, **k):
            watch.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                watch.paused -= 1

        setattr(module, name, paused)
    try:
        with watch:
            out = fn(*args)
    finally:
        for (module, name), f in saved.items():
            setattr(module, name, f)
    return out, watch.reads, watch.collectives


def _task_split(rank, world, payload):
    """The three pieces over ``STEPS`` steps at each grad_acc_steps, each
    piece watched, beside ``make_train_step`` over the group from the same
    weights and generator state."""
    from rdmnet_tpu_torch.engine import create_train_state, make_train_step
    from rdmnet_tpu_torch.engine.train_step import (_update_half, batch_inputs, build_batch,
                                                    exchange, make_gradient_half)
    from rdmnet_tpu_torch.models import RDMNet

    group = dist.group.WORLD
    out = {}
    for grad_acc, n_steps in STEPS.items():
        cfg = _cfg(grad_acc)
        states, gens = [], []
        for _ in range(2):  # the pieces, and make_train_step's twin
            model = RDMNet(cfg, device="cpu")
            model.load_state_dict(payload["state_dict"], strict=True)
            states.append(create_train_state(cfg, model, steps_per_epoch=10, dp_size=world))
            gens.append(torch.Generator())
            gens[-1].set_state(payload["gen_states"][rank])
        gradient_half = make_gradient_half(cfg, "cpu")
        step = make_train_step(cfg, "cpu", group)
        steps = []
        for i in range(n_steps):
            host = {k: v.copy() for k, v in payload["pairs"][rank].items()}
            if i == NAN_STEP and rank == 1:
                host["transform"][0, 0, 3] = np.nan
            inputs = {k: torch.tensor(v) for k, v in batch_inputs(host).items()}
            (flat, stacked, names), r1, c1 = _watched(
                lambda: gradient_half(states[0], build_batch(inputs, cfg.pyramid), gens[0]))
            _, r2, c2 = _watched(exchange, flat, stacked, group)
            metrics, r3, c3 = _watched(_update_half, states[0], (flat, stacked, names), world)
            _, twin = step(states[1], build_batch(inputs, cfg.pyramid), gens[1])
            steps.append(dict(
                reads=(r1, r2, r3), collectives=(c1, c2, c3),
                metrics={k: float(v) for k, v in metrics.items()},
                twin_metrics={k: float(v) for k, v in twin.items()},
                grads=[g.view_as(p).clone() for g, p in
                       zip(torch.split(flat, [p.numel() for p in states[0].params]),
                           states[0].params)] if i == 0 else None,
                state=_state_digests(states[0]), twin_state=_state_digests(states[1]),
                generators=torch.equal(gens[0].get_state(), gens[1].get_state())))
        out[grad_acc] = steps
    return dict(steps=out)


def _rank_main(rank, world, store, out_dir, task, payload):
    """Entry of a spawned rank, as ``test_torch_port_parallel.py``'s: one
    thread, gloo through the file store, the task's result as ``rank<r>.pt``."""
    torch.set_num_threads(1)
    from rdmnet_tpu_torch.parallel import initialize_distributed

    initialize_distributed(backend="gloo", init_method=f"file://{store}", world_size=world,
                           rank=rank)
    try:
        result = globals()[task](rank, world, payload)
        result["jax_imported"] = any(m.split(".")[0] in ("jax", "rdmnet_tpu") for m in sys.modules)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, task, world, payload, timeout=300):
    """``test_torch_port_parallel.py``'s ``_spawn`` over this module's tasks."""
    import torch.multiprocessing as mp

    out = tmp_path / f"{task}-{world}"
    out.mkdir()
    ctx = mp.start_processes(_rank_main, args=(world, str(out / "store"), str(out), task,
                                               payload), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task} at world {world} ran past {timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def split(one_process, tmp_path_factory):
    payload = {k: one_process[k] for k in ("pairs", "state_dict", "gen_states")}
    return _spawn(tmp_path_factory.mktemp("split"), "_task_split", WORLD, payload)


# ---------------------------------------------------------- the pieces

@pytest.mark.parametrize("grad_acc", sorted(STEPS))
def test_halves_read_nothing_back_and_only_the_exchange_communicates(split, grad_acc):
    for r in split:
        assert not r["jax_imported"]
        for i, s in enumerate(r["steps"][grad_acc]):
            assert s["reads"] == ([], [], []), (r, i)
            assert s["collectives"] == ([], ["c10d.allreduce_"] * 2, []), i


@pytest.mark.parametrize("grad_acc", sorted(STEPS))
def test_a_nan_on_one_rank_skips_the_update_on_both(split, grad_acc):
    want = {1: dict(count=[1, 1, 2], notfinite_count=[0, 1, 0], mini_step=[0, 0, 0]),
            2: dict(count=[0, 0, 0, 1], notfinite_count=[0, 1, 1, 0],
                    mini_step=[1, 0, 1, 0])}[grad_acc]
    for r in split:
        steps = r["steps"][grad_acc]
        for i, s in enumerate(steps):
            assert np.isfinite(s["metrics"]["grad_norm"]) == (i != NAN_STEP), i
        got = {k: [s["state"]["counters"][k] for s in steps] for k in want}
        assert got == want
        # the NaN step leaves the weights and moments as the step before it left them
        for kind in ("weights", "exp_avg", "exp_avg_sq"):
            assert steps[NAN_STEP]["state"][kind] == steps[NAN_STEP - 1]["state"][kind], kind
        assert steps[-1]["state"]["weights"] != steps[0]["state"]["weights"]


@pytest.mark.parametrize("grad_acc", sorted(STEPS))
def test_state_bit_equal_across_ranks_and_to_make_train_step(split, grad_acc):
    r0, r1 = split
    for i, (a, b) in enumerate(zip(r0["steps"][grad_acc], r1["steps"][grad_acc])):
        assert a["state"] == b["state"], i
        assert a["metrics"] == b["metrics"] or not np.isfinite(a["metrics"]["grad_norm"]), i
        for s in (a, b):
            assert s["state"] == s["twin_state"] and s["generators"], i
            assert s["metrics"] == s["twin_metrics"] or i == NAN_STEP, i


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("grad_acc", sorted(STEPS))
def test_step1_losses_match_jax_two_pair_step(split, one_process, grad_acc, name):
    """``test_dp_losses_match_jax_two_pair_step``'s bounds."""
    for r in split:
        np.testing.assert_allclose(r["steps"][grad_acc][0]["metrics"][name],
                                   one_process["jmetrics"][name], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("grad_acc", sorted(STEPS))
def test_step1_gradients_match_jax_two_pair_step(split, one_process, grad_acc):
    """``test_dp_gradients_match_jax_two_pair_step``'s bounds."""
    first = split[0]["steps"][grad_acc][0]
    np.testing.assert_allclose(first["metrics"]["grad_norm"],
                               one_process["jmetrics"]["grad_norm"], rtol=2e-3)
    jg = {n: v.numpy() for n, v in one_process["jgrads"].items()}
    for n in [n for n in jg if n.endswith("kernel_points")]:
        assert not jg.pop(n).any()  # stop-gradient there, buffers here
    tg = dict(zip(one_process["names"], (g.numpy() for g in first["grads"])))
    assert set(jg) == set(tg)
    total = np.sqrt(sum(float((g ** 2).sum()) for g in jg.values()))
    diff = {n: tg[n] - jg[n] for n in jg}
    assert np.sqrt(sum(float((d ** 2).sum()) for d in diff.values())) <= 2e-3 * total
    for n in jg:
        assert np.linalg.norm(diff[n]) <= 1e-2 * np.linalg.norm(jg[n]) + 1e-6 * total, n
    for a, b in zip(first["grads"], split[1]["steps"][grad_acc][0]["grads"]):
        assert torch.equal(a, b)


# ----------------------------------------------------------- the CPU

@pytest.mark.parametrize("what", ["capture_train_step", "SplitProgram"])
def test_dp_program_refuses_the_cpu(what):
    from rdmnet_tpu_torch.engine import create_train_state
    from rdmnet_tpu_torch.engine.train_step import capture_train_step
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.program import SplitProgram

    cfg = make_tiny_cfg()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        if what == "capture_train_step":
            state = create_train_state(cfg, RDMNet(cfg, device="cpu"), steps_per_epoch=4)
            capture_train_step(state, cfg, 1, torch.Generator(), device="cpu",
                               group=dist.group.WORLD)
        else:
            SplitProgram("a dp step", lambda s: s, lambda m: None, lambda m: m, dict,
                         {"x": ((1,), torch.float32)}, torch.device("cpu"))


# ------------------------------------------------------------ trainers

class OverwritingProgram:
    """A stand-in for a captured train program: every call writes the same
    output tensors (10 n + i on call n), as a replay does."""

    def __init__(self):
        self.outputs = {"loss": torch.zeros(()), "PIR": torch.zeros(())}
        self.calls = 0

    def __call__(self, np_batch):
        self.calls += 1
        for i, v in enumerate(self.outputs.values()):
            v.fill_(10.0 * self.calls + i)
        return self.outputs


@pytest.fixture
def programs(monkeypatch):
    """``capture_train_step`` in the Trainer replaced by one that makes an
    ``OverwritingProgram``; the programs made, in order."""
    import rdmnet_tpu_torch.engine.trainer as trainer_mod

    made = []

    def capture(state, cfg, batch_size, generator, device=None, group=None):
        made.append(OverwritingProgram())
        return made[-1]

    monkeypatch.setattr(trainer_mod, "capture_train_step", capture)
    return made


def _loader(tmp_path):
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset, write_procedural_root
    from rdmnet_tpu_torch.data.loader import PairLoader

    root = str(tmp_path / "kitti")
    write_procedural_root(root, "kitti", {0: (1, 5), 6: (2, 3)}, n_rings=16, n_azimuths=200)
    return PairLoader(RegistrationPairDataset("kitti", root, "train", point_limit=500),
                      cap=make_tiny_cfg().pyramid.caps[0], seed=1)


def _logged(out_dir):
    with open(os.path.join(out_dir, "logs", "train.log")) as f:
        return [(int(m[1]), float(m[2]), float(m[3]))
                for m in re.finditer(r"iter (\d+)/\d+ \| loss: ([\d.]+), PIR: ([\d.]+)", f.read())]


@pytest.mark.parametrize("kind", ["Trainer", "IterBasedTrainer"])
def test_trainers_on_a_program_log_each_steps_own_values(kind, programs, tmp_path):
    from rdmnet_tpu_torch.engine import Trainer
    from rdmnet_tpu_torch.engine.iter_trainer import IterBasedTrainer

    cfg = dataclasses.replace(make_tiny_cfg(), optim=dataclasses.replace(make_tiny_cfg().optim,
                                                                         max_epoch=1))
    loader = _loader(tmp_path)
    out = str(tmp_path / "out")
    if kind == "Trainer":
        trainer = Trainer(cfg, loader, output_dir=out, log_steps=2, device="cpu")
        trainer.use_programs = True
        summary = trainer.train_epoch()
        n = programs[0].calls
        assert len(programs) == 1 and n == len(loader) >= 3
        want = 10.0 * (n - 0.5)  # the last window's two steps, 10 (n - 1) and 10 n
        assert summary["loss"] == pytest.approx(want) and summary["PIR"] == pytest.approx(want + 1)
    else:
        trainer = IterBasedTrainer(cfg, loader, output_dir=out, log_steps=1, device="cpu",
                                   max_iterations=5, snapshot_every=100, val_every=100)
        trainer.use_programs = True
        trainer.run()
        assert len(programs) == 1 and programs[0].calls == 5
        assert _logged(out) == [(n, 10.0 * n, 10.0 * n + 1) for n in range(1, 6)]


def test_iter_trainer_resume_drops_the_programs(programs, tmp_path):
    """A resumed ``IterBasedTrainer`` restores the state and captures its
    train program anew: the one made before the restore takes no step."""
    from rdmnet_tpu_torch.engine.iter_trainer import IterBasedTrainer

    out = str(tmp_path / "out")
    trainer = IterBasedTrainer(make_tiny_cfg(), _loader(tmp_path), output_dir=out, log_steps=1,
                               device="cpu", max_iterations=3, snapshot_every=2, val_every=100)
    trainer.use_programs = True
    trainer.run()
    before = trainer.train_program
    assert programs == [before] and before.calls == 3
    trainer.eval_program = object()  # a program captured before the restore
    trainer.max_iterations = 5
    trainer.run(resume=True)  # from snapshot 2: iterations 3, 4 and 5
    assert len(programs) == 2 and trainer.train_program is programs[1] is not before
    assert before.calls == 3 and programs[1].calls == 3 and trainer.eval_program is None
    assert [n for n, _, _ in _logged(out)] == [1, 2, 3, 3, 4, 5]
    assert [loss for _, loss, _ in _logged(out)] == [10.0, 20.0, 30.0, 10.0, 20.0, 30.0]
