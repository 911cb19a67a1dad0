"""The port's overfit demo (``rdmnet_tpu_torch/tools/overfit_demo.py``) on the
CPU against the JAX package's: ``demo_pair`` against the recipe of
``scripts/overfit_demo.py`` (bit for bit), ``isotropic_transform_error``
against ``rdmnet_tpu/losses/evaluator.py`` (1e-5 degrees, 1e-6 m), and
``run`` at ``make_tiny_cfg()`` from the JAX package's initial weights, whose
loss falls over 12 steps as ``tests/test_train.py::test_loss_decreases_overfit``
asserts of the JAX loop. The port runs on one thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.engine.train_step import create_train_state as jax_create_train_state
from rdmnet_tpu.graph.pyramid import build_pair_batch as jax_build_pair_batch
from rdmnet_tpu.graph.pyramid import pad_cloud as jax_pad_cloud
from rdmnet_tpu.losses.evaluator import isotropic_transform_error as jax_ite
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.losses.evaluator import isotropic_transform_error
from rdmnet_tpu_torch.tools import overfit_demo
from rdmnet_tpu_torch.utils.convert import params_from_jax

ROW_FIELDS = {"step", "loss", "c_loss", "g_loss", "PIR", "IR", "RR", "RRE", "RTE", "ms_per_step"}


def _jax_recipe(ref):
    """``scripts/overfit_demo.py:57-67`` on a scan in place of the demo file."""
    ref = ref[:, :3].astype(np.float32)
    rng = np.random.RandomState(0)
    angle = np.deg2rad(104.0)
    axis = np.array([0.2, -0.1, 1.0])
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = (np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)).astype(np.float32)
    t = np.array([3.0, -2.0, 0.5], np.float32)
    tf_gt = np.eye(4, dtype=np.float32)
    tf_gt[:3, :3] = R
    tf_gt[:3, 3] = t
    src = ((ref - t) @ R).astype(np.float32) + rng.randn(*ref.shape).astype(np.float32) * 0.02
    return ref, src, tf_gt


@pytest.fixture(scope="module")
def small_pair():
    """The demo's recipe on a 500-point procedural scan (the tiny caps)."""
    scan = procedural_pair(overfit_demo.SCAN_SEED, n_rings=16, n_azimuths=200)[0]
    scan = scan[np.random.RandomState(0).permutation(len(scan))[:500]]
    return overfit_demo.demo_pair(scan)


@pytest.mark.parametrize("n_rings,n_azimuths", [(16, 200), (80, 3000)])
def test_demo_pair_is_the_jax_recipe(n_rings, n_azimuths):
    scan = procedural_pair(overfit_demo.SCAN_SEED, n_rings=n_rings, n_azimuths=n_azimuths)[0]
    got, want = overfit_demo.demo_pair(scan), _jax_recipe(scan)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


def test_demo_scan_fits_the_bucket():
    ref = overfit_demo.demo_scan()
    assert len(ref) <= overfit_demo.demo_cfg().pyramid.caps[0]


def _perturbed(tf, angles, seed):
    """``tf`` moved by rotations of the given angles (radians) about random
    axes and by random translations of ~0.3 m."""
    rng = np.random.RandomState(seed)
    axes = rng.randn(len(angles), 3)
    w = axes / np.linalg.norm(axes, axis=1, keepdims=True) * np.asarray(angles)[:, None]
    d = np.tile(np.eye(4), (len(angles), 1, 1))
    for i, wi in enumerate(w):
        k = np.array([[0, -wi[2], wi[1]], [wi[2], 0, -wi[0]], [-wi[1], wi[0], 0]])
        th = np.linalg.norm(wi)
        d[i, :3, :3] = np.eye(3) + np.sin(th) / th * k + (1 - np.cos(th)) / th ** 2 * (k @ k)
    d[:, :3, 3] = rng.randn(len(angles), 3) * 0.3
    return (d @ tf).astype(np.float32)


@pytest.mark.parametrize("which", ["gt", "perturbed", "batch"])
def test_isotropic_transform_error_matches_jax(small_pair, which):
    """Near 0 degrees arccos turns one ulp of the trace into ~0.02 degrees, so
    the port's trace takes XLA's rounding; ``batch``: 2000 poses at angles
    from 1e-4 degrees to 180. RRE within 1e-5 degrees plus one float32 ulp of
    the angle (1.5e-5 degrees past 128: the two arccos round apart there)."""
    tf_gt = small_pair[2]
    if which == "gt":
        est = tf_gt
    elif which == "perturbed":
        est = _perturbed(tf_gt, [0.05], 0)[0]
    else:
        est = _perturbed(tf_gt, np.deg2rad(np.geomspace(1e-4, 180.0, 2000)), 1)
    gt = np.broadcast_to(tf_gt, est.shape).copy()
    rre, rte = isotropic_transform_error(torch.from_numpy(gt), torch.from_numpy(est))
    want_rre, want_rte = jax_ite(jnp.asarray(gt), jnp.asarray(est))
    np.testing.assert_allclose(rre.numpy(), np.asarray(want_rre), rtol=2.0 ** -23, atol=1e-5)
    np.testing.assert_allclose(rte.numpy(), np.asarray(want_rte), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_run(small_pair):
    """``run`` at ``make_tiny_cfg()`` for 12 steps from the JAX package's
    ``create_train_state(cfg, PRNGKey(0), batch)`` weights, on one thread."""
    ref, src, tf_gt = small_pair
    cfg = make_tiny_cfg()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, lr=5e-4,
                                                             grad_acc_steps=1))
    jcfg = jax_tiny_cfg()
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid,
                                                                 approx_recall=None))
    cap = jcfg.pyramid.caps[0]
    (rp, rc), (sp, sc) = jax_pad_cloud(jnp.asarray(ref), cap), jax_pad_cloud(jnp.asarray(src), cap)
    batch = jax_build_pair_batch(rp, rc, sp, sc, jnp.asarray(tf_gt), jcfg.pyramid)
    params = params_from_jax(jax.device_get(
        jax_create_train_state(jcfg, jax.random.PRNGKey(0), batch).params))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        demo = overfit_demo.run(cfg, ref, src, tf_gt, steps=12, log_every=4, device="cpu",
                                params=params, verbose=False)
    finally:
        torch.set_num_threads(threads)
    return demo


def test_run_lowers_the_loss(tiny_run):
    losses = tiny_run.losses
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_run_rows_have_the_jax_line_fields(tiny_run):
    rows = tiny_run.rows
    assert [r["step"] for r in rows] == [1, 4, 8, 12]
    for row in rows:
        assert set(row) == ROW_FIELDS
        assert all(np.isfinite(v) for v in row.values()), row
        text = overfit_demo.row_text(row)
        assert text.startswith(f"step {row['step']:4d} | loss ") and text.endswith(" ms/step")
    assert [r["loss"] for r in rows] == [tiny_run.losses[i - 1] for i in (1, 4, 8, 12)]
    assert set(tiny_run.final) == {"PIR", "IR", "RR", "RRE", "RTE"}
    assert overfit_demo.final_text(tiny_run.final).startswith("FINAL: RR ")
    assert tiny_run.state.count == 12 and tiny_run.n_evals == 5
    # the plain versions ran: no kernel counted a launch on the CPU
    assert all(n == 0 for per in tiny_run.launches.values() for n in per.values())


def test_run_on_cuda_raises_without_a_card(small_pair):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        overfit_demo.run(make_tiny_cfg(), *small_pair, steps=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        overfit_demo.main(["--steps", "1"])


def test_card_vs_cpu_holds_a_run_to_its_own_copy(tiny_run):
    """``card_vs_cpu`` (``hold_card_to_cpu``, phase 16's checks and the replay
    on the other run's node pairs) of the trained tiny model against a copy
    on its own build of the same host arrays: every check holds."""
    check = overfit_demo.card_vs_cpu(make_tiny_cfg(), tiny_run, tiny_run.host["transform"][0])
    names = [c.name for c in check["checks"]]
    assert names == ["tables", "node masks", "near-ties", "plans", "LGR sets", "LGR scores",
                     "LGR residuals", "LGR pose", "replay plans", "replay pose",
                     "whole-path pose"]
    assert check["ok"] and all(c.status == "ok" for c in check["checks"]), \
        overfit_demo.card_vs_cpu_text(check)
    assert check["parted"] == 0 and check["common"] > 0


def _matched(pairs, scores, m=8):
    """Outputs of a run that matched ``pairs`` (ref, src) with ``scores``."""
    ref, src = zip(*pairs)
    k = len(pairs)
    return {"ref_node_corr_indices": torch.tensor(ref), "src_node_corr_indices": torch.tensor(src),
            "node_corr_valid": torch.ones(k, dtype=torch.bool),
            "node_corr_scores": torch.tensor(scores), "src_node_masks": torch.ones(m, 4),
            "matching_scores": torch.arange(k * 4, dtype=torch.float32).reshape(k, 2, 2)}


def test_near_tie_plan_error_holds_nothing_without_a_common_pair():
    a = _matched([(0, 1), (2, 3)], [0.5, 0.5])
    b = _matched([(4, 5), (6, 7)], [0.5, 0.5000001])
    err, common, parted, gap = overfit_demo.near_tie_plan_error(a, b)
    assert err is None and common == 0 and parted == 4
    assert gap == pytest.approx((float(np.float32(0.5000001)) - 0.5) / 0.5)
    b = _matched([(0, 1), (6, 7)], [0.5, 0.6])
    err, common, parted, gap = overfit_demo.near_tie_plan_error(a, b)
    assert (err, common, parted) == (0.0, 1, 2)
    assert gap == pytest.approx((float(np.float32(0.6)) - 0.5) / 0.5)


def _trace(index, residuals, best=0, gate=(True, True)):
    return {"ver_scores": torch.tensor([0.9, 0.8, 0.7, 0.6]),
            "ver_index": None if index is None else torch.tensor(index),
            "residuals": [torch.tensor(r) for r in residuals], "best": torch.tensor(best),
            "gate": torch.tensor(gate)}


def test_lgr_parting_names_the_first_other_decision():
    radius = 0.6
    hyp = [[0.1, 0.7, 0.3], [0.59995, 0.2, 0.9]]
    refine = [[0.1, 0.2, 0.61]]
    same = _trace([0, 1, 2], [hyp, refine])
    assert overfit_demo.lgr_parting(same, _trace([0, 1, 2], [hyp, refine]), radius) is None
    # the correspondence limit kept another entry: its score's distance from the k-th
    name, margin, at = overfit_demo.lgr_parting(same, _trace([0, 1, 3], [hyp, refine]), radius)
    assert (name, at) == ("correspondence limit", None) and margin == pytest.approx(0.1)
    # the same entries in another order decide alike
    swapped = _trace([1, 0, 2], [[[r[1], r[0], r[2]] for r in hyp], [[0.2, 0.1, 0.61]]])
    assert overfit_demo.lgr_parting(swapped, same, radius) is None
    # an inlier of hypothesis 1 decided on the other side of the radius
    flip = [[0.1, 0.7, 0.3], [0.60005, 0.2, 0.9]]
    name, margin, at = overfit_demo.lgr_parting(_trace([0, 1, 2], [flip, refine]), same, radius)
    assert (name, at) == ("inliers of the hypotheses", 1)
    assert margin == pytest.approx(5e-5, rel=1e-3)
    # ... unless that hypothesis may not be chosen
    gated = _trace([0, 1, 2], [hyp, refine], gate=(True, False))
    assert overfit_demo.lgr_parting(_trace([0, 1, 2], [flip, refine], gate=(True, False)),
                                    gated, radius) is None
    # a refinement's inlier
    name, margin, at = overfit_demo.lgr_parting(_trace([0, 1, 2], [hyp, [[0.1, 0.2, 0.58]]]),
                                                same, radius)
    assert (name, at) == ("inliers of refinement 1", 1) and margin == pytest.approx(0.02, rel=1e-3)
    name, margin, at = overfit_demo.lgr_parting(_trace([0, 1, 2], [hyp, refine], best=1), same,
                                                radius)
    assert (name, at) == ("best hypothesis", 0) and margin == float("inf")
    # no correspondence limit: every entry, in order
    whole = [[[0.1, 0.7, 0.3, 0.2]], [[0.1, 0.2, 0.61, 0.3]]]
    assert overfit_demo.lgr_parting(_trace(None, whole, gate=(True,)),
                                    _trace(None, whole, gate=(True,)), radius) is None


def test_horn_gap_reads_the_fits_conditioning():
    """A fit to points spread in 3-D has a wide eigen-gap; to points on one
    line the rotation about that line is free and the gap closes."""
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randn(50, 3).astype(np.float32))
    w = torch.ones(50)
    assert overfit_demo.horn_gap(src, src, w) > 0.2
    line = torch.from_numpy(np.outer(rng.randn(50), [1.0, 2.0, 0.5]).astype(np.float32))
    assert overfit_demo.horn_gap(line, line, w) < 1e-6


# ---- the demo's learning curves, JAX's loop beside the port's -----------------

REDUCED_POINTS = 3000                           # demo scan rows kept at the reduced size
REDUCED_CAPS = (3072, 2688, 1920, 1024, 512)    # every row kept; 512 nodes as at full width


def compare_configs(size):
    """(JAX cfg, port cfg, ref, src, tf_gt) of the demo's recipe at ``size``:
    ``tiny`` is ``make_tiny_cfg()`` on the 500-point scan of ``small_pair``;
    ``reduced`` is ``make_cfg()``'s model, matching and losses (4 + 4
    ThDRoFormer layers, 40 neighbours, 128 points a patch, 256
    correspondences, 100 Sinkhorn iterations) on ``REDUCED_POINTS`` rows of the
    demo scan, with capacities that keep every row and no search bands. Both
    at lr 5e-4 without accumulation."""
    from rdmnet_tpu.config import make_cfg as jax_make_cfg
    from rdmnet_tpu_torch.config import make_cfg

    if size == "tiny":
        scan = procedural_pair(overfit_demo.SCAN_SEED, n_rings=16, n_azimuths=200)[0]
        scan = scan[np.random.RandomState(0).permutation(len(scan))[:500]]
        jcfg, pcfg = jax_tiny_cfg(), make_tiny_cfg()
        jspec = dataclasses.replace(jcfg.pyramid, approx_recall=None)
    else:
        scan = overfit_demo.demo_scan()
        scan = scan[np.random.RandomState(0).permutation(len(scan))[:REDUCED_POINTS]]
        jcfg, pcfg = jax_make_cfg(), make_cfg()
        jspec = dataclasses.replace(jcfg.pyramid, approx_recall=None, caps=REDUCED_CAPS,
                                    band_caps=(None,) * 5)
    jcfg = dataclasses.replace(jcfg, pyramid=jspec, optim=dataclasses.replace(
        jcfg.optim, lr=5e-4, grad_acc_steps=1))
    pcfg = dataclasses.replace(pcfg, pyramid=dataclasses.replace(
        pcfg.pyramid, caps=jspec.caps, band_caps=jspec.band_caps),
        optim=dataclasses.replace(pcfg.optim, lr=5e-4, grad_acc_steps=1))
    return (jcfg, pcfg) + overfit_demo.demo_pair(scan)


def compare(pkg, size, keys, steps):
    """Train from the JAX package's ``create_train_state(cfg, PRNGKey(0),
    batch)`` weights with JAX's loop (target-draw keys ``keys``) or the
    port's (generators seeded ``keys``, one thread) for ``steps`` steps; per
    key, the loss, c_loss, g_loss and training PIR of every step, the eval
    step's PIR, IR, RR, RRE and RTE after the last, the seconds and the
    process's peak resident memory so far (MiB), one JSON line."""
    import json
    import resource
    import time

    from rdmnet_tpu.engine.train_step import make_eval_step as jax_make_eval_step
    from rdmnet_tpu.engine.train_step import make_train_step as jax_make_train_step
    from rdmnet_tpu_torch.engine import (batch_to_device, create_train_state,
                                         make_eval_step, make_train_step)
    from rdmnet_tpu_torch.models import RDMNet

    jcfg, pcfg, ref, src, tf_gt = compare_configs(size)
    cap = jcfg.pyramid.caps[0]
    (rp, rc), (sp, sc) = jax_pad_cloud(jnp.asarray(ref), cap), jax_pad_cloud(jnp.asarray(src), cap)
    jbatch = jax.jit(lambda: jax_build_pair_batch(rp, rc, sp, sc, jnp.asarray(tf_gt),
                                                  jcfg.pyramid))()
    state0 = jax_create_train_state(jcfg, jax.random.PRNGKey(0), jbatch)
    names = ("loss", "c_loss", "g_loss", "PIR")
    for k in keys:
        t0, hist = time.time(), []
        if pkg == "jax":
            batch1 = jax.tree.map(lambda x: x[None], jbatch)
            step, state, key = jax_make_train_step(jcfg), state0, jax.random.PRNGKey(k)
            for _ in range(steps):
                key, sub = jax.random.split(key)
                state, m = step(state, batch1, sub)
                hist.append({n: float(m[n]) for n in names})
            ev, _ = jax_make_eval_step(jcfg)(state, batch1)
        else:
            torch.set_num_threads(1)
            batch = batch_to_device(overfit_demo.host_batch(ref, src, tf_gt, cap), pcfg.pyramid,
                                    device="cpu")
            model = RDMNet(pcfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.device_get(state0.params)), strict=True)
            state, step = create_train_state(pcfg, model), make_train_step(pcfg, device="cpu")
            gen = torch.Generator().manual_seed(k)
            for _ in range(steps):
                state, m = step(state, batch, gen)
                hist.append({n: float(m[n]) for n in names})
            ev, _ = make_eval_step(pcfg, device="cpu")(state, batch)
        print(json.dumps({"pkg": pkg, "size": size, "key": k, "hist": hist,
                          "eval": {n: float(ev[n]) for n in ("PIR", "IR", "RR", "RRE", "RTE")},
                          "s": time.time() - t0,
                          "peak_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}),
              flush=True)


if __name__ == "__main__":
    # python -m tests.test_torch_port_overfit {jax|port} {tiny|reduced} FIRST-LAST [STEPS]
    import sys

    jax.config.update("jax_platforms", "cpu")
    lo, _, hi = sys.argv[3].partition("-")
    compare(sys.argv[1], sys.argv[2], range(int(lo), int(hi or lo) + 1),
            int(sys.argv[4]) if len(sys.argv) > 4 else 50)
