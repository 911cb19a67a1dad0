"""Ground-truth labels, target sampling, the seven loss terms and the
Evaluator of the PyTorch port against the JAX package, on the CPU.

Inputs are synthetic output dicts made from numpy seeds, the same arrays on
both sides. Tolerances:
* ground-truth overlaps, vote masks and radius labels: exact (both sides
  decide them on XLA's float32 distance rounding);
* each loss term: value at rtol 1e-5, and its gradient with respect to every
  float input against ``jax.value_and_grad`` of the JAX term at rtol 1e-4
  with an absolute floor of 1e-6 times the gradient's largest entry (float32
  sums in another order). Gradients with respect to node coordinates take a
  floor of 5e-4 times the largest entry: the JAX package differentiates
  ``|x|^2 - 2 x.y + |y|^2`` term by term, whose float32 cancellation at 20 m
  coordinates leaves ~1e-4 of relative error, where the port's exact
  distances carry less;
* Evaluator: PIR, IR and RR exact, RTE at 1e-5 m, RRE at 1e-3 degrees (an
  arccos near 1 magnifies the trace's last bits).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.config import make_cfg as jax_make_cfg
from rdmnet_tpu.losses import Evaluator as JaxEvaluator
from rdmnet_tpu.losses import losses as jl
from rdmnet_tpu.ops import correspondences as jcorr
from rdmnet_tpu.ops import geometry as jgeo
from rdmnet_tpu.ops.partition import point_to_node_partition as jax_partition
from rdmnet_tpu_torch.config import make_cfg
from rdmnet_tpu_torch.data import procedural as tproc
from rdmnet_tpu_torch.losses import Evaluator
from rdmnet_tpu_torch.losses import losses as tl
from rdmnet_tpu_torch.nn.matching import superpoint_target_sample
from rdmnet_tpu_torch.ops import correspondences as tcorr

T = torch.from_numpy


def _rigid(rng, max_angle=0.3, max_shift=3.0):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-max_angle, max_angle)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
    tf[:3, 3] = rng.uniform(-max_shift, max_shift, 3)
    return tf


def _to_src(points, tf):
    """Points in the ref frame -> the src frame (tf maps src onto ref)."""
    return ((points - tf[:3, 3]) @ tf[:3, :3]).astype(np.float32)


def _masked(n, n_valid):
    return np.arange(n) < n_valid


@pytest.fixture(scope="module")
def scan_pair():
    """A procedural scan and a moved, jittered copy, with the transform."""
    scans, _ = tproc.procedural_sequence(21, 1, n_rings=24, n_azimuths=400)
    rng = np.random.RandomState(3)
    ref = scans[0][rng.permutation(len(scans[0]))[:1500], :3].astype(np.float32)
    tf = _rigid(rng)
    src = _to_src(ref[rng.permutation(len(ref))[:1400]] + rng.randn(1400, 3).astype(np.float32)
                  * 0.15, tf)
    return ref, src, tf


def _pad(points, cap):
    out = np.full((cap, 3), 1e9, np.float32)
    out[:len(points)] = points
    return out, _masked(cap, len(points))


# ----------------------------------------------------- ground-truth labels

def _patches(points, mask, n_nodes, k, seed):
    """Nodes (every len/n_nodes-th point, two of them invalid) and their kNN
    patches from the JAX partition."""
    nodes = points[:: len(points) // n_nodes][:n_nodes].copy()
    node_mask = np.ones(n_nodes, bool)
    node_mask[np.random.RandomState(seed).choice(n_nodes, 2, replace=False)] = False
    _, node_masks, knn_idx, knn_masks = jax_partition(jnp.asarray(points), jnp.asarray(mask),
                                                      jnp.asarray(nodes), jnp.asarray(node_mask), k)
    knn_pts = np.asarray(jnp.take(jnp.asarray(points), knn_idx, axis=0, mode="fill", fill_value=0.0))
    return nodes, np.asarray(node_masks), knn_pts, np.asarray(knn_masks)


@pytest.mark.parametrize("num_candidates", [3072, 300])
def test_node_correspondence_overlaps_exact(scan_pair, num_candidates):
    """All M*N pairs as candidates, and a top-300 of them (JAX: approx_max_k,
    exact on the CPU; the port: exact top-k)."""
    ref, src, tf = scan_pair
    rp, rm = _pad(ref, 1600)
    sp, sm = _pad(src, 1600)
    args = _patches(rp, rm, 48, 32, 1), _patches(sp, sm, 44, 32, 2)
    (rn, rnm, rk, rkm), (sn, snm, sk, skm) = args
    want = np.asarray(jcorr.node_correspondence_overlaps(
        *map(jnp.asarray, (rn, sn, rk, sk, tf)), 0.6, *map(jnp.asarray, (rnm, snm, rkm, skm)),
        num_candidates=num_candidates))
    got = tcorr.node_correspondence_overlaps(
        T(rn), T(sn), T(rk), T(sk), T(tf), 0.6, T(rnm), T(snm), T(rkm), T(skm),
        num_candidates=num_candidates).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0.1).sum() >= 10 and ((want > 0) & (want <= 0.1)).sum() >= 1


def test_mutual_nearest_node_masks_exact(scan_pair):
    ref, src, tf = scan_pair
    rng = np.random.RandomState(4)
    rn, sn = ref[::30][:40], src[::30][:40]
    rm, sm = rng.rand(40) < 0.9, rng.rand(40) < 0.9
    for radius in (2.4, 0.5):  # squared distance against the radius, as the reference
        want = np.asarray(jcorr.mutual_nearest_node_masks(
            *map(jnp.asarray, (rn, sn, tf)), radius, jnp.asarray(rm), jnp.asarray(sm)))
        got = tcorr.mutual_nearest_node_masks(T(rn), T(sn), T(tf), radius, T(rm), T(sm)).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any()


def test_radius_correspondence_masks_exact(scan_pair):
    ref, src, tf = scan_pair
    src_t = np.asarray(jgeo.apply_transform(jnp.asarray(src), jnp.asarray(tf)))
    rp, rm = _pad(ref, 1600)
    sp, sm = _pad(src_t, 1600)
    for radius, chunk in ((0.6, 2048), (0.3, 500)):  # one chunk, and four with a ragged last
        want = jcorr.radius_correspondence_masks(*map(jnp.asarray, (rp, sp, rm, sm)), radius,
                                                 chunk=chunk)
        got = tcorr.radius_correspondence_masks(T(rp), T(sp), T(rm), T(sm), radius, chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert 0 < np.asarray(w).sum() < len(ref)


@pytest.mark.parametrize("eligible", [0, 5, 16, 40])
def test_superpoint_target_sample_properties(eligible):
    """Only eligible pairs, no repeats, min(eligible, num_targets) valid
    slots, and their overlaps read from the matrix (0 on invalid slots)."""
    rng = np.random.RandomState(eligible)
    m, n, num_targets = 12, 10, 16
    overlaps = np.zeros((m, n), np.float32)
    flat = rng.choice(m * n, eligible + 6, replace=False)
    overlaps.reshape(-1)[flat[:eligible]] = rng.uniform(0.11, 1.0, eligible)
    overlaps.reshape(-1)[flat[eligible:]] = rng.uniform(0.01, 0.1, 6)  # below the threshold
    for seed in range(3):
        ri, si, ov, valid = superpoint_target_sample(T(overlaps), num_targets, 0.1,
                                                     torch.Generator().manual_seed(seed))
        ri, si, ov, valid = ri.numpy(), si.numpy(), ov.numpy(), valid.numpy()
        assert ri.shape == si.shape == ov.shape == valid.shape == (num_targets,)
        assert ri.dtype == si.dtype == np.int32 and valid.dtype == bool
        assert valid.sum() == min(eligible, num_targets)
        pairs = ri[valid] * n + si[valid]
        assert len(set(pairs.tolist())) == len(pairs)
        assert (overlaps[ri[valid], si[valid]] > 0.1).all()
        np.testing.assert_array_equal(ov[valid], overlaps[ri[valid], si[valid]])
        assert (ov[~valid] == 0).all()
    if eligible > num_targets:  # the sample moves with the generator
        draws = set()
        for s in range(4):
            ri, si, _, _ = superpoint_target_sample(T(overlaps), num_targets, 0.1,
                                                    torch.Generator().manual_seed(s))
            draws.add(tuple(sorted((ri * n + si).tolist())))
        assert len(draws) > 1


# ------------------------------------------------------------- loss terms

def _outputs(seed=0):
    """A synthetic output dict at small shapes with the model's layout:
    pads of the pyramid at 1e9, missing patch slots at the origin (the
    sentinel gather's fill), masked plan entries at -1e12, a fully masked
    patch, labels on the dustbin (no partner, or a nearer pad) and exact
    distance ties between duplicated src points."""
    rng = np.random.RandomState(seed)
    tf = _rigid(rng)
    nf, nc, c, p, k = 300, 40, 32, 12, 16

    ref_f = rng.uniform([0, 0, 0], [20, 20, 2], (nf, 3)).astype(np.float32)
    src_f = _to_src(ref_f[rng.permutation(nf)] + rng.randn(nf, 3).astype(np.float32) * 0.4, tf)
    ref_fm, src_fm = _masked(nf, 280), _masked(nf, 290)
    ref_f[~ref_fm], src_f[~src_fm] = 1e9, 1e9
    ref_c, src_c = ref_f[::7][:nc].copy(), src_f[::7][:nc].copy()
    ref_cm, src_cm = _masked(nc, 37), _masked(nc, 39)
    ref_c[~ref_cm], src_c[~src_cm] = 1e9, 1e9

    centers = rng.uniform([2, 2, 0], [18, 18, 2], (p, 3))
    ref_k = (centers[:, None] + rng.randn(p, k, 3) * 0.8).astype(np.float32)
    src_k = ref_k + rng.randn(p, k, 3).astype(np.float32) * 0.3
    src_k[:, ::5] += 5.0                          # no partner: the dustbin
    src_k[:, 1::4] = src_k[:, 0::4]               # duplicated slots: distance ties
    ref_k[0, 3] = tf[:3, 3] + 0.1                 # nearer the src pad (origin) than any point
    src_k = np.stack([_to_src(s, tf) for s in src_k])
    ref_km, src_km = rng.rand(p, k) < 0.85, rng.rand(p, k) < 0.85
    ref_km[-1], src_km[-1] = False, False         # a fully masked patch
    ref_k[~ref_km], src_k[~src_km] = 0.0, 0.0
    plan = (rng.randn(p, k + 1, k + 1) * 2).astype(np.float32)
    plan[:, 2, 5:9] = plan[:, 2, 4:5]             # tied scores
    live = np.concatenate([ref_km, np.ones((p, 1), bool)], 1)[:, :, None] & \
        np.concatenate([src_km, np.ones((p, 1), bool)], 1)[:, None, :]
    plan[~live] = -1e12

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    ref_fc = unit(rng.randn(nc, c))
    src_fc = unit(ref_fc[rng.permutation(nc)] + rng.randn(nc, c) * 0.5)
    overlaps = np.zeros((nc, nc), np.float32)
    idx = rng.choice(nc * nc, 90, replace=False)
    overlaps.reshape(-1)[idx[:60]] = rng.uniform(0.11, 1.0, 60)
    overlaps.reshape(-1)[idx[60:]] = rng.uniform(0.01, 0.1, 30)
    out = {
        "ref_points_f": ref_f, "src_points_f": src_f, "ref_mask_f": ref_fm, "src_mask_f": src_fm,
        "ref_points_c": ref_c, "src_points_c": src_c, "ref_mask_c": ref_cm, "src_mask_c": src_cm,
        "shifted_ref_points_c": np.where(ref_cm[:, None], ref_c + rng.randn(nc, 3) * 0.5,
                                         ref_c).astype(np.float32),
        "shifted_src_points_c": np.where(src_cm[:, None], src_c + rng.randn(nc, 3) * 0.5,
                                         src_c).astype(np.float32),
        "vote_mask_mat": (rng.rand(nc, nc) < 0.03) & ref_cm[:, None] & src_cm[None, :],
        "ref_feats_c": ref_fc, "src_feats_c": src_fc, "gt_node_corr_overlaps": overlaps,
        "nodes_ref_valid": rng.rand(nc) < 0.9, "nodes_src_valid": rng.rand(nc) < 0.9,
        "ref_node_corr_knn_points": ref_k, "src_node_corr_knn_points": src_k,
        "ref_node_corr_knn_masks": ref_km, "src_node_corr_knn_masks": src_km,
        "matching_scores": plan,
    }
    for name, n in (("n2p", nc), ("p2p", nf), ("n2n", nc)):
        for side in ("ref", "src"):
            out[f"{side}_{name}_scores_c"] = rng.uniform(0.02, 0.98, n).astype(np.float32)
    return out, tf


# term name -> (JAX callable, port callable, float inputs it differentiates)
def _terms():
    jcfg, tcfg = jax_make_cfg(), make_cfg()
    scores = [f"{s}_{n}_scores_c" for n in ("n2p", "p2p", "n2n") for s in ("ref", "src")]
    shifted = ["shifted_ref_points_c", "shifted_src_points_c"]
    return {
        "coarse": (jl.CoarseMatchingLoss(jcfg), tl.CoarseMatchingLoss(tcfg), lambda r: r,
                   ["ref_feats_c", "src_feats_c"], False),
        "gap": (jl.GapLoss(jcfg), tl.GapLoss(tcfg), lambda r: r, ["matching_scores"], True),
        "n2p": (jl.OverlapLoss(jcfg), tl.OverlapLoss(tcfg), lambda r: r[0], scores[:2], True),
        "p2p": (jl.OverlapLoss(jcfg), tl.OverlapLoss(tcfg), lambda r: r[1], scores[2:4], True),
        "vote": (jl.VoteLoss(jcfg), tl.VoteLoss(tcfg), lambda r: r[0], shifted, True),
        "n2n": (jl.VoteLoss(jcfg), tl.VoteLoss(tcfg), lambda r: r[1], scores[4:], True),
        "chamfer": (jl.SingleSideChamferLoss(), tl.SingleSideChamferLoss(), lambda r: r,
                    shifted, False),
        "overall": (jl.OverallLoss(jcfg), tl.OverallLoss(tcfg), lambda r: r["loss"],
                    ["ref_feats_c", "src_feats_c", "matching_scores"] + shifted + scores, True),
    }


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("term", ["coarse", "gap", "n2p", "p2p", "vote", "n2n", "chamfer",
                                  "overall"])
def test_loss_term_value_and_grad(term, seed):
    jfn, tfn, pick, keys, takes_batch = _terms()[term]
    out, tf = _outputs(seed)
    fixed = {k: v for k, v in out.items() if k not in keys}

    def jloss(floats):
        o = {**{k: jnp.asarray(v) for k, v in fixed.items()}, **floats}
        res = jfn(o, types.SimpleNamespace(transform=jnp.asarray(tf))) if takes_batch else jfn(o)
        return pick(res)

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))({k: jnp.asarray(out[k]) for k in keys})
    floats = {k: T(out[k].copy()).requires_grad_() for k in keys}
    o = {**{k: T(np.array(v)) for k, v in fixed.items()}, **floats}
    res = tfn(o, types.SimpleNamespace(transform=T(tf))) if takes_batch else tfn(o)
    tval = pick(res)
    tval.backward()
    assert np.isfinite(float(jval)) and float(jval) > 0
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    for k in keys:
        want = np.asarray(jgrad[k])
        got = floats[k].grad.numpy()
        assert np.abs(want).max() > 0, k
        floor = 5e-4 if k.startswith("shifted") else 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=floor * np.abs(want).max(),
                                   err_msg=k)


def test_gap_loss_labels_reach_the_dustbin_and_ties():
    """The synthetic plan of the loss tests does exercise the dustbin and
    the tie breaks: checked here on the labels the term derives."""
    out, tf = _outputs(0)
    ref_k, src_k = out["ref_node_corr_knn_points"], out["src_node_corr_knn_points"]
    src_kt = src_k @ tf[:3, :3].T + tf[:3, 3]
    d = ((ref_k[:, :, None] - src_kt[:, None]) ** 2).sum(-1)
    valid = out["ref_node_corr_knn_masks"][:, :, None] & out["src_node_corr_knn_masks"][:, None]
    d = np.where(valid, d, np.inf)
    near = (d < 0.36).any(2)
    assert (~near & out["ref_node_corr_knn_masks"]).sum() > 10      # dustbin labels
    two = np.sort(d, axis=2)[:, :, :2]
    assert ((two[..., 0] == two[..., 1]) & near).sum() > 10          # tied nearest partners


def test_evaluator_matches_jax():
    rng = np.random.RandomState(5)
    out, tf = _outputs(2)
    est = _rigid(rng, max_angle=0.05, max_shift=0.5) @ tf
    n_corr, nc = 200, out["gt_node_corr_overlaps"].shape[0]
    src_corr = rng.uniform(0, 20, (n_corr, 3)).astype(np.float32)
    ref_corr = (src_corr @ tf[:3, :3].T + tf[:3, 3] + rng.randn(n_corr, 3) * 0.4).astype(np.float32)
    ev_out = {
        "gt_node_corr_overlaps": out["gt_node_corr_overlaps"],
        "ref_node_corr_indices": rng.randint(0, nc, 64).astype(np.int32),
        "src_node_corr_indices": rng.randint(0, nc, 64).astype(np.int32),
        "node_corr_valid": rng.rand(64) < 0.8,
        "ref_corr_points": ref_corr, "src_corr_points": src_corr,
        "corr_scores": np.where(rng.rand(n_corr) < 0.7, rng.rand(n_corr), 0).astype(np.float32),
        "estimated_transform": est.astype(np.float32),
    }
    ev_out["ref_node_corr_indices"][:20] = np.nonzero(out["gt_node_corr_overlaps"])[0][:20]
    ev_out["src_node_corr_indices"][:20] = np.nonzero(out["gt_node_corr_overlaps"])[1][:20]
    jcfg = jax_make_cfg()
    want = JaxEvaluator(jcfg)({k: jnp.asarray(v) for k, v in ev_out.items()},
                              types.SimpleNamespace(transform=jnp.asarray(tf)))
    got = Evaluator(make_cfg())({k: T(v) for k, v in ev_out.items()},
                                types.SimpleNamespace(transform=T(tf)))
    assert set(got) == set(want) == {"PIR", "IR", "RRE", "RTE", "RR"}
    for key in ("PIR", "IR", "RR"):
        assert float(got[key]) == float(want[key]), key
    assert 0 < float(want["PIR"]) < 1 and 0 < float(want["IR"]) < 1
    np.testing.assert_allclose(float(got["RTE"]), float(want["RTE"]), atol=1e-5)
    np.testing.assert_allclose(float(got["RRE"]), float(want["RRE"]), atol=1e-3)
    assert float(want["RR"]) == 1.0
    train_metrics = Evaluator(make_cfg())({k: T(v) for k, v in ev_out.items()}, None,
                                          evaling=False)
    assert set(train_metrics) == {"PIR"}


def test_optimal_transport_training_route_gradient():
    """The plain Sinkhorn under autograd (the training route) against the JAX
    package's scan: the plan and its gradient with respect to the scores and
    the dustbin ``alpha``, with masked rows, columns and a masked patch.
    rtol 1e-4 with a floor of 1e-5 of the largest gradient entry."""
    from rdmnet_tpu.nn.sinkhorn import LearnableLogOptimalTransport as JaxOT
    from rdmnet_tpu_torch.nn.sinkhorn import LearnableLogOptimalTransport

    rng = np.random.RandomState(11)
    p, k, iters = 6, 16, 10
    scores = (rng.randn(p, k, k) * 2).astype(np.float32)
    row_valid, col_valid = rng.rand(p, k) < 0.8, rng.rand(p, k) < 0.8
    row_valid[-1], col_valid[-1] = False, False
    weights = rng.randn(p, k + 1, k + 1).astype(np.float32)
    live = np.concatenate([row_valid, np.ones((p, 1), bool)], 1)[:, :, None] & \
        np.concatenate([col_valid, np.ones((p, 1), bool)], 1)[:, None, :]
    weights[~live] = 0.0  # masked entries hold -1e12; their weight would swamp the sum

    jot = JaxOT(iters)

    def jloss(alpha, s):
        out = jot.apply({"params": {"alpha": alpha}}, s, row_valid, col_valid)
        return (out * weights).sum(), out

    (jval, jplan), (jg_alpha, jg_s) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                                 has_aux=True))(
        jnp.float32(1.3), jnp.asarray(scores))
    ot = LearnableLogOptimalTransport(iters)
    with torch.no_grad():
        ot.alpha.fill_(1.3)
    s = T(scores.copy()).requires_grad_()
    plan = ot(s, T(row_valid), T(col_valid), use_kernel=False)
    (plan * T(weights)).sum().backward()
    np.testing.assert_allclose(plan.detach().numpy()[live], np.asarray(jplan)[live], rtol=1e-4,
                               atol=1e-4)
    want = np.asarray(jg_s)
    np.testing.assert_allclose(s.grad.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(ot.alpha.grad), float(jg_alpha), rtol=1e-4)
    assert float(jg_alpha) != 0.0
