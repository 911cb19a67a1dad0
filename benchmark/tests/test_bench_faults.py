"""Whole runs of the tiny cells on the CPU, the harness's look for a card
skipped: a sound program comes out correct, and each fault the cells can
have comes out not correct. The register cells can alter an answer where
it is produced (its correspondences or its pose) or lose it; the train cell
can return its state unchanged, and can go wrong only in the calls after
its capture (stale inputs, frozen draws, a dropped update: the checked steps
are those calls); the data-parallel cell (four gloo ranks here) can leave
the exchange out or half of the global batch. A rank that loads JAX stops
the run without a result."""

import sys
import types

import numpy as np
import pytest
import torch

import benchmark.run as run
from benchmark.tests.tiny import make_checkout

SEED = 2 ** 31 + 777


def run_cell(root, cell):
    return run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                    require_card=False, device="cpu", root=root, t_start=0.0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # the CPU's products round by thread count: the reference runs with the
    # data-parallel ranks' two threads
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield make_checkout(tmp_path_factory.mktemp("bench"))
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["tiny.register", "tiny.train", "tiny.dp"])
def test_sound_program_is_correct(root, cell):
    line = run_cell(root, cell)
    assert line["correct"] is True
    assert all(c["limit"] is not None for c in line["checks"].values())
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("alter", ["points", "scores"])
def test_altered_answer_is_not_correct(root, monkeypatch, alter):
    from rdmnet_tpu_torch import serving

    load = serving.load_exported

    def load_altered(*args, **kwargs):
        serve, meta = load(*args, **kwargs)

        def altered(ref, src):
            out = dict(serve(ref, src))
            if alter == "points":  # every correspondence's source point moved 1 mm
                out["src_corr_points"] = out["src_corr_points"] + np.float32(1e-3)
            else:  # every score off by 1e-3
                out["corr_scores"] = np.where(out["corr_scores"] > 0,
                                              out["corr_scores"] + np.float32(1e-3), 0)
            return out

        return altered, meta

    monkeypatch.setattr(serving, "load_exported", load_altered)
    assert run_cell(root, "tiny.register")["correct"] is False


def turned(pose: np.ndarray, degrees: float) -> np.ndarray:
    c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
    turn = np.eye(4, dtype=pose.dtype)
    turn[:2, :2] = [[c, -s], [s, c]]
    return turn @ pose


@pytest.mark.parametrize("alter", ["rotation", "translation", "eigenvector"])
def test_altered_pose_is_not_correct(root, monkeypatch, alter):
    from rdmnet_tpu_torch import serving

    load = serving.load_exported

    def load_altered(*args, **kwargs):
        serve, meta = load(*args, **kwargs)

        def altered(ref, src):
            out = dict(serve(ref, src))
            pose = out["estimated_transform"].copy()
            if alter == "rotation":  # turned by 1 degree about z
                pose = turned(pose, 1.0)
            elif alter == "translation":  # moved 10 cm
                pose[0, 3] += np.float32(0.1)
            else:  # the rotation of another eigenvector: turned half about z
                pose = turned(pose, 180.0)
            out["estimated_transform"] = pose
            return out

        return altered, meta

    monkeypatch.setattr(serving, "load_exported", load_altered)
    line = run_cell(root, "tiny.register")
    assert line["correct"] is False
    assert line["checks"]["corr_rows_differ_max"]["value"] == 0.0
    assert line["checks"]["pose_gap_max"]["value"] > line["checks"]["pose_gap_max"]["limit"]


def test_unchanged_state_is_not_correct(root, monkeypatch):
    from rdmnet_tpu_torch.engine.train_step import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients",
                        lambda self, grads: torch.zeros((), dtype=torch.bool))
    line = run_cell(root, "tiny.train")
    assert line["correct"] is False
    assert line["checks"]["change_gap_first"]["value"] == pytest.approx(1.0)


def test_lost_answer_is_not_correct(root, monkeypatch):
    from rdmnet_tpu_torch import serving

    load = serving.load_exported

    def load_failing(*args, **kwargs):
        serve, meta = load(*args, **kwargs)
        calls = []

        def failing(ref, src):
            calls.append(1)
            if len(calls) % 3 == 0:  # past the warm-up, one request in three never answers
                raise RuntimeError("lost")
            return serve(ref, src)

        return failing, meta

    monkeypatch.setattr(serving, "load_exported", load_failing)
    line = run_cell(root, "tiny.register")
    assert line["failed"] > 0 and line["correct"] is False


@pytest.mark.parametrize("fault", ["stale_inputs", "frozen_draws", "dropped_update"])
def test_fault_after_the_capture_is_not_correct(root, monkeypatch, fault):
    """A fault in the calls after the program's capture, which the eager
    warm-ups and the capture do not have: the inputs left as the capture's
    (static inputs not refreshed), the target draws the capture's (a
    generator not registered with the graph), the update not applied."""
    from benchmark.harness.drivers import train

    make = train.make_program

    def faulty(state, cfg, batch_size, generator, device):
        program = make(state, cfg, batch_size, generator, device)
        calls, captured = [], {}

        def call(batch):
            calls.append(batch)
            if len(calls) == 3:  # the capture's call
                captured.update(batch=batch, draws=generator.get_state())
            if len(calls) > 3:
                if fault == "stale_inputs":
                    batch = captured["batch"]
                elif fault == "frozen_draws":
                    generator.set_state(captured["draws"])
                else:
                    state.apply_gradients = lambda grads: torch.zeros((), dtype=torch.bool)
            return program(batch)

        return call

    monkeypatch.setattr(train, "make_program", faulty)
    line = run_cell(root, "tiny.train")
    assert line["correct"] is False


def load_forbidden():
    """Rank hook: the rank loads a module the benchmark may never load."""
    sys.modules.setdefault("flax", types.ModuleType("flax"))


def test_rank_that_loads_jax_stops_the_run(root, monkeypatch, capsys):
    from benchmark.harness.drivers import train_dp

    monkeypatch.setattr(train_dp, "RANK_HOOK", "benchmark.tests.test_bench_faults:load_forbidden")
    with pytest.raises(SystemExit) as stop:
        run_cell(root, "tiny.dp")
    assert stop.value.code == 3
    out, err = capsys.readouterr()
    assert out == "" and "flax (rank 0)" in err


def drop_exchange():
    """Rank hook: the gradient exchange left out (each rank keeps its own)."""
    from rdmnet_tpu_torch.engine import train_step

    train_step.exchange = lambda flat, stacked, group: None


def drop_half():
    """Rank hook: the upper half of the ranks' pairs left out of the global
    batch, the mean taken over the rest."""
    import torch.distributed as dist

    from rdmnet_tpu_torch.engine import train_step

    exchange, means = train_step.exchange, train_step._means

    def half_exchange(flat, stacked, group):
        if dist.get_rank(group) >= dist.get_world_size(group) // 2:
            flat.zero_()
            stacked.zero_()
        exchange(flat, stacked, group)

    train_step.exchange = half_exchange
    train_step._means = lambda state, flat, stacked, names, world: means(
        state, flat, stacked, names, world // 2)


@pytest.mark.parametrize("hook", ["drop_exchange", "drop_half"])
def test_dp_faults_are_not_correct(root, monkeypatch, hook):
    from benchmark.harness.drivers import train_dp

    monkeypatch.setattr(train_dp, "RANK_HOOK", f"benchmark.tests.test_bench_faults:{hook}")
    assert run_cell(root, "tiny.dp")["correct"] is False
