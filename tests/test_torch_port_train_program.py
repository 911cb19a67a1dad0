"""The Trainer's steps without host reads, on the CPU.

On the card the Trainer runs its train and eval steps, each with its graph
build, as captured CUDA graphs (``engine.train_step.capture_train_step`` /
``capture_eval_step``); for that the non-finite guard, the schedule and the
accumulation group live on the device, and no op of either step may read a
value back. A CUDA graph cannot run here, so these tests hold what the CPU
can show:

* a ``TorchDispatchMode`` that raises on the ops that read the device
  (``_local_scalar_dense``, ``nonzero``, ``masked_select``, ``equal``,
  ``is_nonzero``, the ``unique`` family and bool-mask indexing) over the
  tiny-config train step with its build (grad_acc_steps 1 and 2) and over
  the eval step. The CPU runs the plain versions of the card's kernels, some
  of which read counts back; each is excepted by name with the kernel the
  card runs in its place;
* the guard in a real step: a NaN in the ground-truth transform skips the
  update, leaves the weights and ``count`` as they were and counts one
  non-finite step;
* the counters' checkpoint round trip into the state's device tensors;
* ``build_pair_batch`` takes the truncation counts as tensors, equal to ints;
* the Trainer copies each step's metrics out of the step's outputs, so a
  program that overwrites its outputs logs each step's own values;
* the capture functions refuse the CPU.

Everything here is the port alone; the optax comparisons of the guard and the
schedule are in ``test_torch_port_train.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.engine import checkpoint as ckpt
from rdmnet_tpu_torch.engine import (
    Trainer,
    batch_to_device,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from rdmnet_tpu_torch.engine.train_step import (
    batch_inputs,
    build_batch,
    capture_eval_step,
    capture_train_step,
)
from rdmnet_tpu_torch.graph.pyramid import build_pair_batch
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.ops.kernels import eigh4 as eigh4_module
from rdmnet_tpu_torch.ops.kernels import nms as nms_module
from rdmnet_tpu_torch.ops.kernels import radius_knn as knn_module
from rdmnet_tpu_torch.ops.kernels import segment_sum as segment_module
from rdmnet_tpu_torch.tools.overfit_demo import host_batch

CAP = 512
aten = torch.ops.aten
READS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten.equal,
         aten.is_nonzero, aten._unique2, aten.unique_consecutive, aten.unique_dim}
INDEXING = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}
# the plain versions the CPU runs where the card launches a kernel of its own
CARD_KERNELS = {
    (knn_module, "radius_knn_plain"): "csrc/radius_knn.cu (the plain search's counts)",
    (segment_module, "segment_sums_plain"): "csrc/segment_sum.cu (the plain loop's length)",
    (nms_module, "nms_peel_plain"): "csrc/nms.cu (the plain loop's rounds)",
    (eigh4_module, "top_eigenvector_plain"): "csrc/eigh4.cu (torch.linalg.eigh, which waits "
                                             "for the host on CUDA)",
}


class HostReads(TorchDispatchMode):
    """Raises on an op that reads a tensor's value back to the host, unless
    a function of ``CARD_KERNELS`` is running."""

    def __init__(self):
        super().__init__()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            packet = func.overloadpacket
            indices = args[1] if packet in INDEXING and len(args) > 1 else ()
            if packet in READS or any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                      for i in indices or ()):
                raise AssertionError(f"{func} reads a value back to the host")
        return func(*args, **kwargs)


@pytest.fixture
def host_reads(monkeypatch):
    mode = HostReads()
    for (module, name), _ in CARD_KERNELS.items():
        fn = getattr(module, name)

        def paused(*a, _fn=fn, **k):
            mode.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                mode.paused -= 1

        monkeypatch.setattr(module, name, paused)
    return mode


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(seed=11, nan_transform=False):
    ref, src, tf = procedural_pair(seed, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(seed)
    ref = ref[rng.permutation(len(ref))[:500]]
    src = src[rng.permutation(len(src))[:480]]
    if nan_transform:
        tf = tf.copy()
        tf[0, 3] = np.nan
    return host_batch(ref, src, tf, CAP)


def _cfg(grad_acc=1):
    cfg = make_tiny_cfg()
    return dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=grad_acc))


def _state(cfg, seed=0):
    return create_train_state(cfg, RDMNet(cfg, device="cpu",
                                          generator=torch.Generator().manual_seed(seed)),
                              steps_per_epoch=4)


def _inputs(host):
    return {k: torch.tensor(v) for k, v in batch_inputs(host).items()}


@pytest.mark.parametrize("grad_acc", [1, 2])
def test_train_step_with_its_build_reads_nothing_back(grad_acc, host_reads, one_thread):
    """The step a program captures: the build from the staged inputs, the
    forward, losses, backward, the guard and Adam, twice (a group of two
    under accumulation), with no op reading the device."""
    cfg = _cfg(grad_acc)
    state = _state(cfg)
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    inputs = _inputs(_host())
    before = [p.detach().clone() for p in state.params]
    with host_reads:
        for _ in range(2):
            state, metrics = step(state, build_batch(inputs, cfg.pyramid), gen)
    assert state.count == 1 + (grad_acc == 1) and state.mini_step == 0
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert max(float((p.detach() - q).abs().max()) for p, q in zip(state.params, before)) > 0


@pytest.mark.parametrize("bsz", [1, 2])
def test_eval_step_with_its_build_reads_nothing_back(bsz, host_reads, one_thread):
    cfg = _cfg()
    state = _state(cfg)
    one = _host()
    host = {k: np.concatenate([v] * bsz) for k, v in one.items()}
    inputs = _inputs(host)
    valid = torch.tensor([True, False][:bsz])
    with host_reads:
        metrics, transforms = make_eval_step(cfg, device="cpu")(
            state, build_batch(inputs, cfg.pyramid), valid)
    want, _ = make_eval_step(cfg, device="cpu")(state, batch_to_device(one, cfg.pyramid, "cpu"))
    assert transforms.shape == (bsz, 4, 4)
    for k, v in want.items():
        assert float(metrics[k]) == float(v), k


def test_a_nan_transform_skips_the_update(one_thread):
    """A NaN in the ground truth makes the gradient non-finite: the update
    is skipped (weights, Adam's state and ``count`` as they were), one
    non-finite step is counted, and the next finite step applies again."""
    cfg = _cfg()
    state = _state(cfg)
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    state, _ = step(state, batch_to_device(_host(), cfg.pyramid, "cpu"), gen)
    weights = [p.detach().clone() for p in state.params]
    moments = [state.optimizer.state[p]["exp_avg"].clone() for p in state.params]
    state, metrics = step(state, batch_to_device(_host(nan_transform=True), cfg.pyramid, "cpu"),
                          gen)
    assert not bool(torch.isfinite(metrics["grad_norm"]))
    assert (state.count, state.notfinite_count) == (1, 1)
    assert all(torch.equal(p, q) for p, q in zip(state.params, weights))
    assert all(torch.equal(state.optimizer.state[p]["exp_avg"], m)
               for p, m in zip(state.params, moments))
    assert all(float(state.optimizer.state[p]["step"]) == 1.0 for p in state.params)
    state, _ = step(state, batch_to_device(_host(), cfg.pyramid, "cpu"), gen)
    assert (state.count, state.notfinite_count) == (2, 0)


@pytest.mark.parametrize("grad_acc", [1, 3])
def test_checkpoint_round_trip_of_the_device_counters(grad_acc, tmp_path, one_thread):
    """The counters are saved as ints and restored into the state's own
    tensors (the ones a captured step reads), with the lr tensor kept."""
    cfg = _cfg(grad_acc)
    state = _state(cfg)
    step = make_train_step(cfg, device="cpu")
    batch = batch_to_device(_host(), cfg.pyramid, "cpu")
    gen = torch.Generator().manual_seed(5)
    for _ in range(4):
        state, _ = step(state, batch, gen)
    state.notfinite_count = 3
    payload = ckpt.state_to_host(state)
    assert {k: payload[k] for k in state.COUNTERS} == \
        {"count": 4 if grad_acc == 1 else 1, "mini_step": 0 if grad_acc == 1 else 1,
         "notfinite_count": 3}
    assert all(isinstance(payload[k], int) for k in state.COUNTERS)
    assert all(isinstance(g["lr"], float) for g in payload["optimizer"]["param_groups"])
    mgr = ckpt.CheckpointManager(str(tmp_path / "snap"))
    mgr.save(1, state)
    fresh = _state(cfg, seed=9)
    tensors = dict(fresh.counters)
    lr, acc = fresh.lr, fresh.accumulator
    restored, _ = mgr.restore(fresh)
    mgr.close()
    assert all(restored.counters[k] is t for k, t in tensors.items())
    assert {k: int(v) for k, v in restored.counters.items()} == \
        {k: payload[k] for k in state.COUNTERS}
    assert restored.lr is lr and all(g["lr"] is lr for g in restored.optimizer.param_groups)
    assert restored.accumulator is acc
    for a, b in zip(restored.accumulator or (), state.accumulator or ()):
        assert torch.equal(a, b)
    # both go on alike: the lr is recomputed from the restored count
    state.notfinite_count = restored.notfinite_count = 0
    step(state, batch, torch.Generator().manual_seed(6))
    step(restored, batch, torch.Generator().manual_seed(6))
    assert torch.equal(restored.lr, state.lr)
    assert all(torch.equal(p, q) for p, q in zip(restored.params, state.params))


def test_dropped_counts_as_tensors_equal_ints():
    """The truncation counts, a captured program's static inputs, may be
    tensors: the pyramid equals the one built from ints."""
    cfg = make_tiny_cfg()
    host = _host()
    t = {k: torch.tensor(v[0]) for k, v in batch_inputs(host).items()}
    args = (t["ref_points"], t["ref_counts"], t["src_points"], t["src_counts"], t["transform"],
            cfg.pyramid)
    from_ints = build_pair_batch(*args, ref_dropped0=7, src_dropped0=2)
    from_tensors = build_pair_batch(*args, ref_dropped0=torch.tensor(7, dtype=torch.int32),
                                    src_dropped0=torch.tensor(2))
    assert torch.equal(from_ints.ref.dropped, from_tensors.ref.dropped)
    assert torch.equal(from_ints.src.dropped, from_tensors.src.dropped)
    assert int(from_tensors.ref.dropped[0]) >= 7 and int(from_tensors.src.dropped[0]) >= 2


def test_batch_to_device_equals_one_build_per_pair():
    cfg = make_tiny_cfg()
    host = {k: np.concatenate([a, b]) for (k, a), b in zip(_host().items(),
                                                           _host(seed=12).values())}
    host["ref_dropped"] = np.array([3, 0], np.int32)
    got = batch_to_device(host, cfg.pyramid, device="cpu")
    for b, pair in enumerate(got):
        (rp, rc), (sp, sc) = ((torch.tensor(host[f"{s}_points"][b]),
                               torch.tensor(host[f"{s}_counts"][b])) for s in ("ref", "src"))
        want = build_pair_batch(rp, rc, sp, sc, torch.tensor(host["transform"][b]), cfg.pyramid,
                                ref_dropped0=int(host["ref_dropped"][b]))
        for side in ("ref", "src"):
            for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
                for x, y in zip(getattr(getattr(pair, side), field),
                                getattr(getattr(want, side), field)):
                    assert torch.equal(x, y), (b, side, field)
            assert torch.equal(getattr(pair, side).dropped, getattr(want, side).dropped)


def test_trainer_logs_each_steps_own_metrics(tmp_path, one_thread):
    """A replayed program returns the same output tensors every step,
    overwritten in place. The Trainer copies each step's metrics before the
    next step, so its window's means are those of the steps' own values."""
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset, write_procedural_root
    from rdmnet_tpu_torch.data.loader import PairLoader

    root = str(tmp_path / "kitti")
    write_procedural_root(root, "kitti", {0: (1, 5), 6: (2, 3)}, n_rings=16, n_azimuths=200)
    cfg = dataclasses.replace(_cfg(), optim=dataclasses.replace(make_tiny_cfg().optim,
                                                                max_epoch=1))
    train = PairLoader(RegistrationPairDataset("kitti", root, "train", point_limit=500),
                       cap=CAP, seed=1)
    trainer = Trainer(cfg, train, output_dir=str(tmp_path / "out"), log_steps=2, device="cpu")
    outputs = {"loss": torch.zeros(()), "PIR": torch.zeros(())}
    calls = []

    def overwriting_step(state, batch, generator):
        calls.append(len(calls))
        for i, v in enumerate(outputs.values()):
            v.fill_(10.0 * len(calls) + i)
        return state, outputs

    trainer.train_step = overwriting_step
    summary = trainer.train_epoch()
    n = len(calls)
    assert n == len(train) >= 3
    want = 10.0 * (n - 0.5)  # the mean of the last window's two steps, 10 (n - 1) and 10 n
    assert summary["loss"] == pytest.approx(want) and summary["PIR"] == pytest.approx(want + 1)
    with open(os.path.join(str(tmp_path / "out"), "logs", "train.log")) as f:
        assert "loss" in f.read()


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_capture_raises_on_the_cpu(kind):
    cfg = make_tiny_cfg()
    state = _state(cfg)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        if kind == "train":
            capture_train_step(state, cfg, 1, torch.Generator(), device="cpu")
        else:
            capture_eval_step(state, cfg, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            capture_train_step(state, cfg, 1, torch.Generator())
