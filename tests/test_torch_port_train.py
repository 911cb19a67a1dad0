"""The training slice of the PyTorch port against the JAX package, on the CPU.

The whole slice: ``batch_to_device`` -> ``make_value_and_grad`` (forward with
``training=True, with_gt=True``, the seven losses, backward) -> one Adam
update, and ``make_eval_step``, at ``make_tiny_cfg()`` on two frames of a
procedural sequence with their true relative pose, against the JAX package's
``create_train_state`` / ``make_value_and_grad`` / optax update with the same
weights (carried across by ``params_from_jax``). Only 6 node pairs of that pair
overlap by more than 0.1 and ``num_targets`` is 16, so both sides sample
every eligible pair, in another order, whatever their random streams; every
loss is a mean over patches, so the order does not matter.

Tolerances:
* pyramid tables, ground-truth overlaps and vote masks, PIR: exact;
* the eight loss values: 1e-4 absolute (rtol 1e-5); ``grad_norm`` rtol 1e-4;
* gradients: per parameter tensor, the norm of the difference within
  1e-2 of the tensor's gradient norm plus 1e-6 of the global norm, and the
  global difference within 2e-3 of the global norm. Measured: 6.9e-4
  globally, at most 1.7e-3 per tensor (the deepest KPConv levels, where
  float32 sums of GroupNorm statistics over a few dozen points feed four
  levels of backward); six tensors whose exact gradient is zero (biases
  followed by a normalisation or a softmax) hold float noise on both sides
  and pass by the global floor. The card holds its gradients to the same
  bounds against the CPU (``test_torch_port_cuda.py``, ``chip_smoke.py``);
* parameters after one Adam step: within 1e-7 of JAX's wherever the JAX
  gradient exceeds 1e-3 of its largest entry (there Adam's first step is
  -lr * sign(g) on both sides); elsewhere the gradient is float noise whose
  sign either side may flip, so only |step| <= lr is held on each side;
* schedules: rtol 1e-6 (JAX computes them in float32); Adam, decay, the
  non-finite skip and accumulation on a toy model: 1e-6 absolute.

The port's side runs on one thread (see ``test_torch_port_model.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.data.procedural import procedural_sequence
from rdmnet_tpu.engine import train_step as jts
from rdmnet_tpu.engine.trainer import batch_to_device as jax_batch_to_device
from rdmnet_tpu.graph.pyramid import pad_cloud as jax_pad_cloud
from rdmnet_tpu.losses import Evaluator as JaxEvaluator
from rdmnet_tpu.models import RDMNet as JaxRDMNet
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.engine import (
    batch_to_device,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_value_and_grad,
)
from rdmnet_tpu_torch.engine.train_step import make_schedule
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.utils.convert import _optax_states, params_from_jax

CAP = 512
LOSSES = ("loss", "c_loss", "g_loss", "n_loss", "p_loss", "v_loss", "nn_loss", "d_loss")


def _host_batch():
    """Frames 0 and 1 of a procedural sequence, subsampled to the tiny
    level-0 capacity, with the transform mapping frame 1 onto frame 0."""
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    ref = scans[0][rng.permutation(len(scans[0]))[:500], :3]
    src = scans[1][rng.permutation(len(scans[1]))[:480], :3]
    tf = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    (rp, rc), (sp, sc) = jax_pad_cloud(jnp.asarray(ref), CAP), jax_pad_cloud(jnp.asarray(src), CAP)
    return {"ref_points": np.asarray(rp)[None], "ref_counts": np.asarray(rc)[None],
            "src_points": np.asarray(sp)[None], "src_counts": np.asarray(sc)[None],
            "transform": tf[None]}


@pytest.fixture(scope="module")
def run():
    """Both sides of one train step and one eval forward on the same pair."""
    host = _host_batch()
    jcfg = jax_tiny_cfg()
    # the port always searches exactly; the JAX CPU path is exact with this
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None))
    jbatch = jax_batch_to_device(host, jcfg.pyramid)
    single = jax.tree.map(lambda x: x[0], jbatch)
    state = jts.create_train_state(jcfg, jax.random.PRNGKey(0), single, steps_per_epoch=10)
    jmetrics, jgrads = jts.make_value_and_grad(jcfg)(state, jbatch, jax.random.PRNGKey(1))
    new_state = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, jgrads)
    jmodel, jeval = JaxRDMNet(jcfg), JaxEvaluator(jcfg)

    @jax.jit
    def forward(params, batch):
        out = jmodel.apply(params, batch, training=False, with_gt=True, use_pallas_sinkhorn=False)
        return {k: out[k] for k in ("gt_node_corr_overlaps", "vote_mask_mat")}, jeval(out, batch)

    jout, jev = forward(state.params, single)
    jev_pir, _ = jts.make_eval_step(jcfg, with_transform=False)(state, jbatch)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params)), strict=True)
    tstate = create_train_state(cfg, model, steps_per_epoch=10)
    before = launch_counts()
    batch = batch_to_device(host, cfg.pyramid, device="cpu")
    with torch.no_grad():
        tout = model(batch[0], training=False, with_gt=True)
    tev, ttf = make_eval_step(cfg, device="cpu")(tstate, batch)
    tev_pir, _ = make_eval_step(cfg, "cpu", with_transform=False)(tstate, batch)
    params0 = [p.detach().clone() for p in tstate.params]
    tmetrics, tgrads = make_value_and_grad(cfg, device="cpu")(tstate, batch,
                                                               torch.Generator().manual_seed(1))
    applied = tstate.apply_gradients(tgrads)
    assert launch_counts() == before  # CPU tensors never reach a kernel
    torch.set_num_threads(threads)
    np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t))  # noqa: E731
    return dict(
        jbatch=jax.tree.map(np.asarray, single), batch=batch[0], jmetrics=jax.tree.map(float, jmetrics),
        tmetrics={k: float(v) for k, v in tmetrics.items()}, jgrads=np_tree(jgrads),
        tgrads=dict(zip([n for n, _ in model.named_parameters()], tgrads)),
        params0=dict(zip([n for n, _ in model.named_parameters()], params0)),
        jparams1=np_tree(new_state.params), tparams1=dict(model.named_parameters()),
        applied=applied, count=tstate.count, jout=jax.tree.map(np.asarray, jout), tout=tout,
        jev=jax.tree.map(float, jev), tev={k: float(v) for k, v in tev.items()}, ttf=ttf,
        jev_pir=jax.tree.map(float, jev_pir), tev_pir={k: float(v) for k, v in tev_pir.items()})


def test_batch_to_device_tables_equal_jax(run):
    jb, tb = run["jbatch"], run["batch"]
    for side in ("ref", "src"):
        jp, tp = getattr(jb, side), getattr(tb, side)
        for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
            for lvl, (j, t) in enumerate(zip(getattr(jp, field), getattr(tp, field))):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{side} {field}[{lvl}]")
        np.testing.assert_array_equal(tp.dropped.numpy(), jp.dropped)
    np.testing.assert_array_equal(tb.transform.numpy(), jb.transform)


def test_ground_truth_targets_exact(run):
    for key in ("gt_node_corr_overlaps", "vote_mask_mat"):
        np.testing.assert_array_equal(run["tout"][key].numpy(), run["jout"][key], err_msg=key)
    eligible = int((run["jout"]["gt_node_corr_overlaps"] > 0.1).sum())
    # the sample is the whole eligible set on both sides (module docstring)
    assert 0 < eligible <= make_tiny_cfg().coarse_matching.num_targets
    assert run["jout"]["vote_mask_mat"].sum() > 0


@pytest.mark.parametrize("name", LOSSES)
def test_loss_values(run, name):
    np.testing.assert_allclose(run["tmetrics"][name], run["jmetrics"][name], rtol=1e-5, atol=1e-4)
    assert np.isfinite(run["tmetrics"][name]) and run["tmetrics"][name] > 0


def test_pir_and_grad_norm(run):
    assert run["tmetrics"]["PIR"] == run["jmetrics"]["PIR"]
    np.testing.assert_allclose(run["tmetrics"]["grad_norm"], run["jmetrics"]["grad_norm"],
                               rtol=1e-4)


def test_parameter_gradients(run):
    jg, tg = dict(run["jgrads"]), run["tgrads"]
    # KPConv's kernel points: stop-gradient parameters in JAX, buffers in the port
    for n in [n for n in jg if n.endswith("kernel_points")]:
        assert not jg.pop(n).numpy().any()
    assert set(jg) == set(tg)
    diff = {n: tg[n].numpy() - jg[n].numpy() for n in jg}
    total = np.sqrt(sum(float((g.numpy() ** 2).sum()) for g in jg.values()))
    total_diff = np.sqrt(sum(float((d ** 2).sum()) for d in diff.values()))
    assert total_diff <= 2e-3 * total, total_diff / total
    for n in jg:
        bound = 1e-2 * np.linalg.norm(jg[n].numpy()) + 1e-6 * total
        assert np.linalg.norm(diff[n]) <= bound, (n, np.linalg.norm(diff[n]), bound)


def test_params_after_one_adam_step(run):
    lr = make_tiny_cfg().optim.lr
    assert run["applied"] and run["count"] == 1
    gmax = max(float(np.abs(g.numpy()).max()) for g in run["jgrads"].values())
    for n, p1 in run["tparams1"].items():
        got, want, p0 = (np.atleast_1d(x) for x in (p1.detach().numpy(), run["jparams1"][n].numpy(),
                                                    run["params0"][n].numpy()))
        sig = np.abs(np.atleast_1d(run["jgrads"][n].numpy())) > 1e-3 * gmax
        np.testing.assert_allclose(got[sig], want[sig], rtol=0, atol=1e-7, err_msg=n)
        for side in (got, want):
            assert np.abs(side - p0).max() <= lr * (1 + 1e-3), n


def test_eval_step(run):
    tev, jev = run["tev"], run["jev"]
    assert set(tev) == set(jev) | {"dropped"}
    assert tev["PIR"] == jev["PIR"]
    jb = run["jbatch"]
    assert tev["dropped"] == float(jb.ref.dropped.sum() + jb.src.dropped.sum())
    assert all(np.isfinite(v) for v in tev.values())
    assert run["ttf"].shape == (1, 4, 4)


def test_eval_step_without_transform_matches_jax(run):
    """``make_eval_step(cfg, device, with_transform=False)`` against JAX's
    ``make_eval_step(cfg, with_transform=False)``: PIR and ``dropped`` only,
    both exact (the tolerance of ``test_eval_step``)."""
    tev, jev = run["tev_pir"], run["jev_pir"]
    assert set(tev) == set(jev) == {"PIR", "dropped"}
    for k in jev:
        assert tev[k] == jev[k], k
    assert tev["PIR"] == run["tev"]["PIR"]


def test_eval_step_weights_valid_pairs():
    """Two pairs with ``valid = [True, False]`` give the first pair's metrics."""
    cfg = make_tiny_cfg()
    host = _host_batch()
    two = {k: np.concatenate([v, v[:, ::-1] if k.endswith("points") else v]) for k, v in
           host.items()}
    state = create_train_state(cfg, RDMNet(cfg, device="cpu"))
    batch = batch_to_device(two, cfg.pyramid, device="cpu")
    step = make_eval_step(cfg, device="cpu")
    one, _ = step(state, batch[:1])
    weighted, tfs = step(state, batch, valid=torch.tensor([True, False]))
    assert tfs.shape == (2, 4, 4)
    for k, v in one.items():
        assert float(weighted[k]) == float(v), k


def test_train_step_updates_the_model():
    cfg = make_tiny_cfg()
    state = create_train_state(cfg, RDMNet(cfg, device="cpu"))
    batch = batch_to_device(_host_batch(), cfg.pyramid, device="cpu")
    before = [p.detach().clone() for p in state.params]
    names = []
    state, metrics = make_train_step(cfg, device="cpu")(
        state, batch, torch.Generator().manual_seed(0), stage_hook=names.append)
    assert names == ["forward", "losses", "backward", "optimizer"]
    assert set(metrics) == set(LOSSES) | {"PIR", "grad_norm"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values()) and float(metrics["grad_norm"]) > 0
    assert state.count == 1
    assert all(p.grad is None for p in state.params)
    assert max(float((p - q).abs().max()) for p, q in zip(state.params, before)) > 0
    assert state.model.optimal_transport.alpha.item() != 1.0  # the dustbin score trains


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = make_tiny_cfg()
    for make in (make_train_step, make_value_and_grad, make_eval_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_to_device(_host_batch(), cfg.pyramid)
    state = create_train_state(cfg, RDMNet(cfg, device="cpu"))
    with pytest.raises(ValueError, match="training=True needs"):
        state.model(batch_to_device(_host_batch(), cfg.pyramid, device="cpu")[0], training=True)


# ------------------------------------------------------------- optimizer

def _optim_cfgs(scheduler, grad_acc):
    o = dict(scheduler=scheduler, grad_acc_steps=grad_acc, lr=1e-2, weight_decay=1e-2,
             lr_decay_steps=2, warmup_steps=6, max_epoch=4)
    jc, tc = jax_tiny_cfg(), make_tiny_cfg()
    return (dataclasses.replace(jc, optim=dataclasses.replace(jc.optim, **o)),
            dataclasses.replace(tc, optim=dataclasses.replace(tc.optim, **o)))


@pytest.mark.parametrize("grad_acc", [1, 3])
@pytest.mark.parametrize("scheduler", ["step", "warmup_cosine"])
def test_schedules_match_optax(scheduler, grad_acc):
    """The schedule the step computes on the device from its count tensor
    (one count at a time, as the step does, and all at once) against optax's."""
    jc, tc = _optim_cfgs(scheduler, grad_acc)
    _, want = jts.create_optimizer(jc, steps_per_epoch=10)
    got = make_schedule(tc, steps_per_epoch=10)
    values = [float(got(torch.tensor(c))) for c in range(51)]
    np.testing.assert_allclose(values, [float(want(c)) for c in range(51)], rtol=1e-6)
    np.testing.assert_array_equal(got(torch.arange(51)).numpy(), values)
    assert got(torch.tensor(0)).dtype == torch.float64
    assert len(set(np.round(values, 12))) >= 3  # the schedule moves inside the window


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(4, 3)
        self.b = torch.nn.Linear(3, 2)


@pytest.mark.parametrize("case", ["decay", "nonfinite", "nonfinite_run", "multisteps",
                                  "multisteps_nonfinite"])
def test_adam_matches_optax(case):
    """The optimizer against the JAX package's optax chain on a toy model,
    fed the same gradients: decay and Adam, a skipped non-finite step, a run
    of 102 non-finite steps (``apply_if_finite`` skips 100 in a row, then
    applies the 101st and 102nd, NaNs and all), and MultiSteps (a non-finite
    micro-batch skips its whole group; the last group, as optax's
    accumulator stays NaN after it). The guard, the counters, the lr and
    the group live on the device: ``apply_gradients`` returns a device
    flag."""
    grad_acc = 3 if case.startswith("multisteps") else 1
    jc, tc = _optim_cfgs("step", grad_acc)
    toy = _Toy()
    with torch.no_grad():
        for p in toy.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    names = [n for n, _ in toy.named_parameters()]
    jparams = {n: jnp.asarray(p.detach().numpy()) for n, p in toy.named_parameters()}
    tx, _ = jts.create_optimizer(jc, steps_per_epoch=2)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    state = create_train_state(tc, toy, steps_per_epoch=2)
    rng = np.random.RandomState(7)
    steps = 104 if case == "nonfinite_run" else 9
    bad = {"nonfinite": [3], "nonfinite_run": range(1, 103), "multisteps_nonfinite": [7]}.get(
        case, [])
    applied = 0
    for i in range(steps):
        grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in toy.named_parameters()}
        if i in bad:
            grads[names[1]][0] = np.nan
        upd, opt_state = update({n: jnp.asarray(g) for n, g in grads.items()}, opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        applied += state.apply_gradients([torch.from_numpy(grads[n]) for n in names])
        for n, p in toy.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} {n}")
    expected = {"decay": 9, "nonfinite": 8, "nonfinite_run": 4, "multisteps": 3,
                "multisteps_nonfinite": 2}[case]
    assert applied == state.count == expected
    assert state.notfinite_count == (case == "multisteps_nonfinite")
    assert int(_optax_states(opt_state)["finite"]["notfinite_count"]) == state.notfinite_count


def test_multisteps_recovers_after_nonfinite_group():
    """Under accumulation a non-finite micro-batch skips its group, and the
    next groups train as if it had never come: the port's parameters equal
    those of the JAX package's optax chain fed the stream without the
    skipped group (atol 1e-6). The port's accumulator restarts from zero;
    optax's keeps the NaN and skips every later group, a departure the port
    makes on purpose."""
    jc, tc = _optim_cfgs("step", 3)
    toy = _Toy()
    with torch.no_grad():
        for p in toy.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    names = [n for n, _ in toy.named_parameters()]
    start = {n: p.detach().numpy().copy() for n, p in toy.named_parameters()}
    jparams = {n: jnp.asarray(v) for n, v in start.items()}
    tx, _ = jts.create_optimizer(jc, steps_per_epoch=2)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    state = create_train_state(tc, toy, steps_per_epoch=2)
    rng = np.random.RandomState(11)
    applied = 0
    for i in range(12):
        grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in toy.named_parameters()}
        if i == 1:
            grads[names[2]][0] = np.inf
        applied += state.apply_gradients([torch.from_numpy(grads[n]) for n in names])
        if i >= 3:  # the reference never sees the first group
            upd, opt_state = update({n: jnp.asarray(g) for n, g in grads.items()},
                                    opt_state, jparams)
            jparams = optax.apply_updates(jparams, upd)
        want = start if i < 3 else jparams
        for n, p in toy.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} {n}")
    assert applied == state.count == 3
    assert state.notfinite_count == 0
