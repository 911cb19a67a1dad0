"""The port's engine on the CPU at ``make_tiny_cfg()``: checkpoints, resume,
``train_state_from_jax`` and the ``Trainer`` against the JAX package's.

The dataset root (written by a fixture) holds two train pairs, each a pair
of frames of one procedural sequence whose ground-truth target set fits
``num_targets`` (so both packages sample all of it, whatever their random
streams; see ``test_torch_port_train.py``), and one validation pair: a scan
against a rigidly moved copy of itself, which the weights of ``PRNGKey(0)``
register. The two Trainers run the JAX package's initial weights at lr 0:
after an Adam step at lr 1e-4 the two packages' weights part by one step on
the entries whose gradient is float noise, enough to flip a top-k choice of
random weights, so the loop is compared at fixed weights, and
``train_state_from_jax`` carries the moments and counts of those two steps
into an update at lr 1e-4 fed the same gradients on both sides.

Tolerances: checkpoints and resume bit for bit; the Trainers' loss records
1e-4 absolute, ``grad_norm`` 2e-3 relative (the gradients' bound in
``test_torch_port_train.py``; measured 2.8e-4), the validation record (PIR, IR,
RR, RRE, RTE, dropped) 1e-4; the step after ``train_state_from_jax``: losses
1e-4, weights 1e-6. The port runs on one thread.
"""

import copy
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.data.datasets import RegistrationPairDataset as JaxDataset
from rdmnet_tpu.data.loader import PairLoader as JaxLoader
from rdmnet_tpu.engine import train_step as jts
from rdmnet_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from rdmnet_tpu.engine.trainer import Trainer as JaxTrainer
from rdmnet_tpu_torch.cli import common, trainval
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.datasets import SCHEMAS, RegistrationPairDataset
from rdmnet_tpu_torch.data.loader import PairLoader
from rdmnet_tpu_torch.data.procedural import procedural_sequence
from rdmnet_tpu_torch.engine import Trainer, batch_to_device, create_train_state, make_train_step
from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager, load_state, state_to_host
from rdmnet_tpu_torch.engine.iter_trainer import IterBasedTrainer, iteration_seed
from rdmnet_tpu_torch.engine.train_step import make_value_and_grad
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.utils.convert import params_from_jax, params_to_jax, train_state_from_jax

SEED = 0
LOSSES = ("loss", "c_loss", "g_loss", "n_loss", "p_loss", "v_loss", "nn_loss", "d_loss", "PIR")
MOTION = np.eye(4, dtype=np.float32)
MOTION[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
MOTION[:3, 3] = [0.5, 0.3, 0.1]


def _write_seq(root, seq, clouds, transforms):
    schema = SCHEMAS["kitti"]
    for i, cloud in enumerate(clouds):
        path = os.path.join(root, schema.cloud_path.format(seq=seq, frame=i))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, cloud)
    path = os.path.join(root, schema.gt_file.format(seq=seq))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(f"{i + 1} {i} " + " ".join(f"{v:.9f}" for v in tf[:3].reshape(-1))
                          for i, tf in enumerate(transforms)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    tf = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    for seq in (0, 1):
        rng = np.random.RandomState(seq)
        _write_seq(root, seq, [scans[0][rng.permutation(len(scans[0]))[:500], :3],
                               scans[1][rng.permutation(len(scans[1]))[:480], :3]], [tf])
    scan, _ = procedural_sequence(11, 1, n_rings=16, n_azimuths=200)
    ref = scan[0][np.random.RandomState(0).permutation(len(scan[0]))[:500], :3]
    _write_seq(root, 6, [ref, ((ref - MOTION[:3, 3]) @ MOTION[:3, :3]).astype(np.float32)],
               [MOTION])
    for seq in (2, 3, 4, 5, 7, 8, 9, 10):
        _write_seq(root, seq, [], [])
    return root


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(lr=1e-4, max_epoch=1, grad_acc=1):
    cfg = make_tiny_cfg()
    return dataclasses.replace(cfg, seed=SEED, optim=dataclasses.replace(
        cfg.optim, lr=lr, max_epoch=max_epoch, grad_acc_steps=grad_acc))


def _jax_cfg(lr=1e-4):
    cfg = jax_tiny_cfg()
    return cfg.replace(seed=SEED, pyramid=dataclasses.replace(cfg.pyramid, approx_recall=None),
                       optim=dataclasses.replace(cfg.optim, lr=lr, max_epoch=1))


def _loaders(root, ds_cls=RegistrationPairDataset, loader_cls=PairLoader, augment=False):
    train = ds_cls("kitti", root, "train", point_limit=500, use_augmentation=augment, seed=SEED)
    val = ds_cls("kitti", root, "val", point_limit=500)
    return (loader_cls(train, cap=512, shuffle=True, drop_last=True, seed=SEED),
            loader_cls(val, cap=512))


def _records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_states_equal(a, b):
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    sa, sb = state_to_host(a), state_to_host(b)
    assert sa["optimizer"]["state"].keys() == sb["optimizer"]["state"].keys()
    for name, st in sa["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["optimizer"]["state"][name][k]), (name, k)
    for k in ("count", "mini_step", "notfinite_count"):
        assert sa[k] == sb[k], k
    assert (sa["accumulator"] is None) == (sb["accumulator"] is None)
    for name, v in (sa["accumulator"] or {}).items():
        assert torch.equal(v, sb["accumulator"][name]), name


# ---------------------------------------------------------------- checkpoints

def _trained_state(root, grad_acc, steps=2):
    cfg = _cfg(grad_acc=grad_acc)
    state = create_train_state(cfg, RDMNet(cfg, device="cpu"), steps_per_epoch=2)
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    train, _ = _loaders(root)
    for batch in list(train)[:steps]:
        state, _ = step(state, batch_to_device(batch, cfg.pyramid, device="cpu"), gen)
    return cfg, state


@pytest.mark.parametrize("grad_acc", [1, 3])
def test_checkpoint_round_trip_bit_for_bit(root, tmp_path, one_thread, grad_acc):
    cfg, state = _trained_state(root, grad_acc)
    assert state.count == (2 if grad_acc == 1 else 0)
    assert (state.accumulator is not None) == (grad_acc > 1)
    mgr = CheckpointManager(str(tmp_path / "snap"))
    mgr.save(2, state, metadata={"epoch": 2, "loss": 1.5})
    fresh = create_train_state(cfg, RDMNet(cfg, device="cpu",
                                           generator=torch.Generator().manual_seed(99)))
    restored, meta = mgr.restore(fresh)
    assert meta == {"epoch": 2, "loss": 1.5}
    _assert_states_equal(restored, state)
    # the restored state trains on exactly as the saved one does
    step = make_train_step(cfg, device="cpu")
    train, _ = _loaders(root)
    batch = batch_to_device(train.peek(), cfg.pyramid, device="cpu")
    step(state, batch, torch.Generator().manual_seed(4))
    step(restored, batch, torch.Generator().manual_seed(4))
    _assert_states_equal(restored, state)
    mgr.close()


def test_max_to_keep_latest_step_and_metadata(root, tmp_path, one_thread):
    _, state = _trained_state(root, 1, steps=1)
    mgr = CheckpointManager(str(tmp_path / "snap"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.read_metadata()
    for step in (1, 2, 3, 4):
        mgr.save(step, state, metadata={"epoch": step})
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(mgr.directory)) == ["3", "4"]
    assert mgr.read_metadata(3) == {"epoch": 3} and mgr.read_metadata() == {"epoch": 4}
    with pytest.raises(FileExistsError):
        mgr.save(4, state)
    mgr.close()


def test_half_written_step_is_ignored(root, tmp_path, one_thread):
    _, state = _trained_state(root, 1, steps=1)
    mgr = CheckpointManager(str(tmp_path / "snap"))
    mgr.save(1, state, metadata={"epoch": 1})
    mgr.wait_until_finished()
    # a run killed mid-write leaves a temporary directory; a step directory
    # missing its metadata is not a snapshot either
    os.makedirs(os.path.join(mgr.directory, ".tmp-2-0123"))
    shutil.copytree(os.path.join(mgr.directory, "1"), os.path.join(mgr.directory, "3"))
    os.remove(os.path.join(mgr.directory, "3", "metadata.json"))
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    assert CheckpointManager(mgr.directory).latest_step() == 1


def test_restore_params_from_grad_acc_snapshot(root, tmp_path, one_thread):
    """Evaluation and warm starts read the weights alone, whatever optimizer
    state the snapshot holds (here an open accumulation group)."""
    cfg, state = _trained_state(root, 4, steps=1)
    assert state.mini_step == 1 and state.accumulator is not None
    mgr = CheckpointManager(str(tmp_path / "snap_acc"))
    mgr.save(1, state, metadata={"epoch": 1})
    mgr.close()
    model = common.build_model_and_params(_cfg(), str(tmp_path / "snap_acc"), device="cpu")
    for (name, x), (_, y) in zip(model.state_dict().items(), state.model.state_dict().items()):
        assert torch.equal(x, y), name
    params = CheckpointManager(str(tmp_path / "snap_acc")).restore_params(1)
    assert params.keys() == state.model.state_dict().keys()


def test_missing_snapshot_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="snapshot_dir not found"):
        common.build_model_and_params(_cfg(), str(tmp_path / "nope"), device="cpu")


def test_restore_refuses_other_parameter_names(root, one_thread):
    cfg, state = _trained_state(root, 1, steps=1)
    payload = state_to_host(state)
    name = next(iter(payload["optimizer"]["state"]))
    payload["optimizer"]["state"]["renamed"] = payload["optimizer"]["state"].pop(name)
    group = payload["optimizer"]["param_groups"][0]
    group["params"] = ["renamed" if n == name else n for n in group["params"]]
    with pytest.raises(ValueError, match="other parameters"):
        load_state(create_train_state(cfg, RDMNet(cfg, device="cpu")), payload)


# --------------------------------------------------------------------- resume

def test_resume_equals_one_run_under_jax_semantics(root, tmp_path, one_thread):
    """One epoch, then a resumed second epoch, equal a run of two epochs
    whose target generator and loaders restart before the second, as a
    resume restarts them (the JAX Trainer's semantics)."""
    run = str(tmp_path / "run")
    Trainer(_cfg(max_epoch=1), *_loaders(root, augment=True), output_dir=run,
            log_steps=1, device="cpu").run()
    resumed = Trainer(_cfg(max_epoch=2), *_loaders(root, augment=True), output_dir=run,
                      log_steps=1, device="cpu")
    resumed.run(resume=True)
    assert resumed.epoch == 2 and resumed.snapshots.all_steps() == [1, 2]

    ref = Trainer(_cfg(max_epoch=2), *_loaders(root, augment=True),
                  output_dir=str(tmp_path / "ref"), log_steps=1, device="cpu")
    first = ref.train_epoch()
    ref.epoch = 1
    ref.generator = torch.Generator().manual_seed(SEED + 1)
    ref.train_loader, _ = _loaders(root, augment=True)
    ref.train_loader.peek()  # as the resumed Trainer's constructor does
    second = ref.train_epoch()
    _assert_states_equal(resumed.state, ref.state)
    train = [r for r in _records(run) if r["phase"] == "train"]
    assert [r["epoch"] for r in train] == [0, 1]
    assert {k: v for k, v in train[0].items() if k not in ("phase", "epoch")} == first
    assert {k: v for k, v in train[1].items() if k not in ("phase", "epoch")} == second


def test_iter_trainer_snapshots_and_resumes(root, tmp_path, one_thread):
    """Snapshots every 2 iterations; a resume starts at the snapshot's
    iteration, mid-pass, with the target generator reseeded for it."""
    out = str(tmp_path / "iter")
    kw = dict(output_dir=out, log_steps=1, device="cpu", snapshot_every=2, val_every=3)
    first = IterBasedTrainer(_cfg(), *_loaders(root), max_iterations=3, **kw)
    first.run()
    assert first.iteration == 3 and first.snapshots.all_steps() == [2]
    assert first.snapshots.read_metadata() == {"iteration": 2}
    assert [v["pairs"] for v in first.val_timings] == [1]
    second = IterBasedTrainer(_cfg(), *_loaders(root), max_iterations=4, **kw)
    second.run(resume=True)
    assert second.iteration == 4 and second.snapshots.all_steps() == [2, 4]
    assert second.state.count == 2 + 2
    # the counterpart of fold_in(key, 2): a seed of its own, not the first run's
    assert second.generator.initial_seed() == iteration_seed(SEED + 1, 2)
    assert first.generator.initial_seed() == SEED + 1
    assert len({iteration_seed(SEED + 1, i) for i in range(4)} | {SEED + 1}) == 5


def test_trainval_cli_trains_and_resumes(root, tmp_path, one_thread):
    out = str(tmp_path / "cli")
    argv = ["--root", root, "--output_dir", out, "--device", "cpu", "--cfg_preset", "tiny",
            "--log_steps", "1", "--no_augmentation", "--keep_snapshots", "1"]
    trainer = trainval.main(argv + ["--max_epoch", "1"])
    assert trainer.epoch == 1 and trainer.cfg.train.use_augmentation is False
    assert [t["steps"] for t in trainer.epoch_timings] == [2]
    assert [t["pairs"] for t in trainer.val_timings] == [1]
    trainer = trainval.main(argv + ["--max_epoch", "2", "--resume"])
    assert trainer.epoch == 2 and trainer.state.count == 4
    assert trainer.snapshots.all_steps() == [2]
    records = _records(out)
    assert [(r["phase"], r["epoch"]) for r in records] == [
        ("train", 0), ("val", 0), ("train", 1), ("val", 1)]
    best = trainer.best_snapshots.read_metadata()
    assert tuple(best["score"]) == max(Trainer._val_score(r) for r in records if r["phase"] == "val")


def test_trainer_entry_points_default_to_cuda(root):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg(), *_loaders(root))
    with pytest.raises(RuntimeError, match="CUDA"):
        common.build_model_and_params(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        trainval.main(["--root", root, "--cfg_preset", "tiny", "--output_dir", "unused"])


# ---------------------------------------------------------- against the JAX one

def _grad_tree(model, grads):
    """The port's gradients (in parameter order) as the flax tree of the JAX
    optimizer, zero for the kernel points (parameters there, buffers here)."""
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
        for name, buf in holder.named_buffers():
            if name.endswith("kernel_points"):
                buf.zero_()
    return params_to_jax(holder)


@pytest.fixture(scope="module")
def trainers(root, tmp_path_factory):
    """The JAX Trainer and the port's, one epoch of 2 steps and a validation
    each, from the JAX Trainer's initial weights at lr 0."""
    out = tmp_path_factory.mktemp("trainers")
    jt = JaxTrainer(_jax_cfg(lr=0.0), *_loaders(root, JaxDataset, JaxLoader),
                    output_dir=str(out / "jax"), log_steps=2)
    params0 = jax.device_get(jt.state.params)
    jt.run()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pt = Trainer(_cfg(lr=0.0), *_loaders(root), output_dir=str(out / "port"), log_steps=2,
                 device="cpu")
    pt.state.model.load_state_dict(params_from_jax(params0), strict=True)
    pt.run()
    torch.set_num_threads(threads)
    return dict(jax=jt, port=pt, jax_dir=str(out / "jax"), port_dir=str(out / "port"))


def test_trainer_records_match_jax(trainers):
    got, want = _records(trainers["port_dir"]), _records(trainers["jax_dir"])
    assert [(r["phase"], r["epoch"]) for r in got] == [(r["phase"], r["epoch"]) for r in want] \
        == [("train", 0), ("val", 0)]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["phase"]
        for key in w:
            if key in ("phase", "epoch"):
                continue
            # a norm moves by at most the norm of the gradients' difference,
            # held to 2e-3 of the global norm (test_torch_port_train.py)
            rtol = 2e-3 if key == "grad_norm" else 0.0
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=1e-4,
                                       err_msg=f"{g['phase']} {key}")
    val = got[1]
    assert val["RR"] == 1.0 and val["RRE"] < 1e-3, val  # the validation pair registers
    assert all(np.isfinite(v) for v in got[0].values() if isinstance(v, float))


def test_trainer_snapshots_match_jax(trainers):
    jt, pt = trainers["jax"], trainers["port"]
    assert pt.snapshots.all_steps() == [jt.snapshots.latest_step()] == [1]
    assert pt.best_snapshots.latest_step() == jt.best_snapshots.latest_step() == 1
    got, want = pt.best_snapshots.read_metadata(), jt.best_snapshots.read_metadata()
    assert set(got) == set(want) and got["epoch"] == want["epoch"] == 1
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-4)
    # a worse epoch leaves the best snapshot alone on both sides
    for t in (jt, pt):
        t._maybe_save_best({"RR": 0.0, "RRE": 999.0, "RTE": 999.0})
        assert t.best_snapshots.read_metadata()["epoch"] == 1


def test_trainer_config_json_keys_match_jax(trainers):
    with open(os.path.join(trainers["port_dir"], "config.json")) as f:
        got = json.load(f)
    with open(os.path.join(trainers["jax_dir"], "config.json")) as f:
        want = json.load(f)
    assert set(got) <= set(want)
    for section, fields in got.items():
        if not isinstance(fields, dict):
            assert fields == want[section], section
            continue
        assert set(fields) <= set(want[section]), section
        for name, value in fields.items():
            assert value == want[section][name], (section, name)
    # the port's pyramid has no approximate search; every other section is whole
    assert {s for s in got if isinstance(got[s], dict) and set(got[s]) != set(want[s])} \
        == {"pyramid", "train", "test", "model"}


def test_train_state_from_jax_continues_the_jax_state(trainers, root, one_thread):
    """The JAX state after the Trainer's 2 steps, restored from its snapshot,
    carried into the port; then one step at lr 1e-4 on each side, fed the same
    gradients: losses within 1e-4, weights within 1e-6."""
    jt = trainers["jax"]
    restored, meta = JaxCheckpointManager(os.path.join(trainers["jax_dir"], "snapshots")).restore(
        jt.state, 1)
    state_np = jax.device_get(restored)
    cfg = _cfg(lr=1e-4)
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    state = train_state_from_jax(state_np, model, cfg, steps_per_epoch=2)
    adam = state_np.opt_state.inner_state[1][0]
    assert state.count == 2 and state.notfinite_count == 0 and int(adam.count) == 2
    mu = params_from_jax(adam.mu)
    st = state.optimizer.state_dict()["state"]
    for i, name in enumerate(state.param_names):
        assert float(st[i]["step"]) == 2.0
        assert torch.equal(st[i]["exp_avg"], mu[name]), name
    assert max(float(v.abs().max()) for v in mu.values()) > 0  # two steps left moments

    # the losses of the Trainer's epoch at these weights (lr 0 kept them)
    train, _ = _loaders(root)
    train.peek()
    vag = make_value_and_grad(cfg, device="cpu")
    runs = [vag(state, batch_to_device(b, cfg.pyramid, device="cpu"),
                torch.Generator().manual_seed(0)) for b in train]
    record = _records(trainers["jax_dir"])[0]
    for name in LOSSES:
        np.testing.assert_allclose(np.mean([float(m[name]) for m, _ in runs]), record[name],
                                   atol=1e-4, err_msg=name)
    grads = runs[0][1]

    tx, _ = jts.create_optimizer(_jax_cfg(lr=1e-4), steps_per_epoch=2)
    jgrads = _grad_tree(model, grads)
    updates, _ = jax.jit(tx.update)(jgrads, state_np.opt_state, state_np.params)
    jparams = params_from_jax(optax.apply_updates(state_np.params, jax.device_get(updates)))
    assert state.apply_gradients(grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert state.count == 3


class _Toy(torch.nn.Module):
    """Two Dense layers and a buffer named as KPConv's kernel points."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(4, 3)
        self.conv = torch.nn.Module()
        self.conv.register_buffer("kernel_points", torch.randn(5, 3))
        self.b = torch.nn.Linear(3, 2)


def test_train_state_from_jax_multisteps():
    """Under MultiSteps: an open group's ``mini_step`` and accumulator carry
    across (Dense kernels transposed, the kernel points' moments dropped), and
    the group completes to the same update on both sides."""
    cfg = _cfg(lr=1e-3, grad_acc=3)
    model = _Toy()
    params = params_to_jax(model)
    jcfg = jax_tiny_cfg().replace(optim=dataclasses.replace(jax_tiny_cfg().optim, lr=1e-3,
                                                            grad_acc_steps=3))
    tx, _ = jts.create_optimizer(jcfg, steps_per_epoch=3)
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    rng = np.random.RandomState(0)
    names = [n for n, _ in model.named_parameters()]

    def draw():
        g = jax.tree.map(lambda x: np.asarray(rng.randn(*np.shape(x)), np.float32), params)
        g["params"]["conv"]["kernel_points"][:] = 0.0  # no gradient, as in the JAX model
        return g

    grads = [draw() for _ in range(6)]
    for g in grads[:4]:  # one whole group, then one micro step of the next
        upd, opt_state = update(g, opt_state, params)
        params = jax.device_get(optax.apply_updates(params, upd))
    state = train_state_from_jax({"params": params, "opt_state": jax.device_get(opt_state)},
                                 model, cfg, steps_per_epoch=3)
    assert (state.count, state.mini_step) == (1, 1)
    acc = params_from_jax(grads[3])
    for name, a in zip(state.param_names, state.accumulator):
        assert torch.equal(a, acc[name]), name
    assert torch.equal(state.accumulator[0], torch.from_numpy(grads[3]["params"]["a"]["kernel"].T))
    for g in grads[4:]:
        upd, opt_state = update(g, opt_state, params)
        params = jax.device_get(optax.apply_updates(params, upd))
        tg = params_from_jax(g)
        state.apply_gradients([tg[n] for n in names])
    assert (state.count, state.mini_step) == (2, 0)
    want = params_from_jax(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
