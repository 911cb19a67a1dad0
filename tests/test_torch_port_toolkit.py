"""The port's library surface of correspondences, geometry, partition, KPConv
helpers, ``log_sinkhorn`` and point matching against the JAX package, on
the CPU.

Inputs come from numpy seeds; the JAX side runs under ``jax.jit`` (the
rounding the port reproduces is XLA's compiled one). The cases follow
``tests/test_correspondence_toolkit.py``'s. Masks, indices and counts must
be equal; floats agree within 1e-6 abs / 1e-5 rel (float32 on both sides,
other summation orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu import config as jcfg
from rdmnet_tpu.nn import kpconv as jkp
from rdmnet_tpu.nn import point_matching as jpm
from rdmnet_tpu.nn.sinkhorn import log_sinkhorn as jax_log_sinkhorn
from rdmnet_tpu.ops import correspondences as JC
from rdmnet_tpu.ops import geometry as jgeo
from rdmnet_tpu.ops.partition import knn_partition as jax_knn_partition
from rdmnet_tpu.utils.se3_np import euler_zyx_matrix
from rdmnet_tpu_torch import config as tcfg
from rdmnet_tpu_torch.nn import kpconv as tkp
from rdmnet_tpu_torch.nn import point_matching as tpm
from rdmnet_tpu_torch.nn.sinkhorn import log_sinkhorn
from rdmnet_tpu_torch.ops import correspondences as TC
from rdmnet_tpu_torch.ops import geometry as tgeo
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.ops.partition import knn_partition

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-6)


def _jit(fn, **static):
    """``fn`` under ``jax.jit`` with the keyword arguments ``static`` fixed."""
    return jax.jit(functools.partial(fn, **static))


def _same(got, want, what=""):
    """Exact for bool/int outputs, TOL for floats."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def _rigid(seed=0):
    rng = np.random.RandomState(seed)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = euler_zyx_matrix(*(0.3 * rng.randn(3))).astype(np.float32)
    t[:3, 3] = rng.randn(3).astype(np.float32)
    return t


# ---------------------------------------------------------------- geometry

def test_geometry_helpers():
    rng = np.random.RandomState(0)
    pts = (rng.rand(50, 3) * 60 - 30).astype(np.float32)
    rot = _rigid(1)[:3, :3]
    rots = np.stack([_rigid(s)[:3, :3] for s in range(4)])
    bpts = rng.randn(4, 9, 3).astype(np.float32)
    _same(tgeo.apply_rotation(T(pts), T(rot)), jax.jit(jgeo.apply_rotation)(pts, rot), "rot")
    _same(tgeo.apply_rotation(T(bpts), T(rots)), jax.jit(jgeo.apply_rotation)(bpts, rots),
          "batched rot")
    v = rng.randn(5, 3).astype(np.float32)
    _same(tgeo.skew_symmetric(T(v)), jax.jit(jgeo.skew_symmetric)(v), "skew")
    angle = rng.uniform(-3, 3, 5).astype(np.float32)
    _same(tgeo.rodrigues_rotation(T(v), T(angle)), jax.jit(jgeo.rodrigues_rotation)(v, angle),
          "rodrigues")
    w = rng.randn(5, 3).astype(np.float32)
    w[0] = 2.5 * v[0]  # parallel: angle 0
    _same(tgeo.vector_angle(T(v), T(w)), jax.jit(jgeo.vector_angle)(v, w), "angle")


@pytest.mark.parametrize("dim", [0, 1])
def test_masked_min_first_index_on_ties(dim):
    rng = np.random.RandomState(2)
    values = rng.randint(0, 4, (7, 9)).astype(np.float32)  # many ties
    mask = rng.rand(7, 9) > 0.3
    mask[0] = False  # an all-masked row: min = big, argmin = 0
    got = tgeo.masked_min(T(values), T(mask), dim)
    want = _jit(jgeo.masked_min, axis=dim)(values, mask)
    _same(got[0], want[0], "min")
    _same(got[1], np.asarray(want[1]).astype(np.int64), "argmin")


# ---------------------------------------------------------------- partition

@pytest.mark.parametrize("masked", [False, True])
def test_knn_partition_ties_by_lower_index(masked):
    rng = np.random.RandomState(3)
    base = (rng.rand(20, 3) * 10).astype(np.float32)
    points = np.concatenate([base, base[::-1], base[:5]])  # duplicates: distance ties
    nodes = points[rng.permutation(len(points))[:6]] + 0.01
    mask = rng.rand(len(points)) > 0.25 if masked else None
    got = knn_partition(T(points), T(nodes), 12, None if mask is None else T(mask))
    want = _jit(jax_knn_partition, k=12)(points, nodes, points_mask=mask)
    _same(got[1], want[1], "indices")
    _same(got[0], want[0], "distances")


# ---------------------------------------------------------------- KPConv helpers

def test_knn_interpolate_and_global_avgpool():
    rng = np.random.RandomState(4)
    n, m, h, c = 40, 17, 6, 8
    s_points = (rng.rand(n, 3) * 5).astype(np.float32)
    q_points = (rng.rand(m, 3) * 5).astype(np.float32)
    s_feats = rng.randn(n, c).astype(np.float32)
    idx = rng.randint(0, n, (m, h)).astype(np.int32)
    idx[rng.rand(m, h) < 0.3] = n  # sentinel slots
    idx[0] = n                      # a query without neighbours
    for k in (1, 3, h):
        _same(tkp.knn_interpolate(T(s_feats), T(q_points), T(s_points), T(idx), k),
              _jit(jkp.knn_interpolate, k=k)(s_feats, q_points, s_points, idx), f"k={k}")
    mask = rng.rand(n) > 0.4
    _same(tkp.global_avgpool(T(s_feats), T(mask)), jax.jit(jkp.global_avgpool)(s_feats, mask))
    none = np.zeros(n, bool)
    _same(tkp.global_avgpool(T(s_feats), T(none)), jax.jit(jkp.global_avgpool)(s_feats, none))


def test_log_sinkhorn_any_leading_dims():
    rng = np.random.RandomState(5)
    scores = rng.randn(2, 3, 5, 6).astype(np.float32)
    log_mu = (rng.randn(2, 3, 5) * 0.1).astype(np.float32)
    log_nu = (rng.randn(2, 3, 6) * 0.1).astype(np.float32)
    _same(log_sinkhorn(T(scores), T(log_mu), T(log_nu), 20),
          _jit(jax_log_sinkhorn, num_iterations=20)(scores, log_mu, log_nu))


# ---------------------------------------------------------------- correspondence toolkit

@pytest.mark.parametrize(
    "mutual,bilateral,dustbin,thr",
    [(False, False, False, 0.0), (True, False, False, 0.3),
     (False, True, False, 0.3), (True, False, True, 0.0)],
)
def test_masks_from_scores(mutual, bilateral, dustbin, thr):
    score = np.random.RandomState(1).randn(8, 11).astype(np.float32)
    kw = dict(mutual=mutual, bilateral=bilateral, has_dustbin=dustbin, threshold=thr)
    _same(TC.correspondence_masks_from_scores(T(score), **kw),
          _jit(JC.correspondence_masks_from_scores, **kw)(score))


def test_threshold_masks():
    score = np.random.RandomState(2).randn(6, 7).astype(np.float32)
    for dustbin in (False, True):
        _same(TC.correspondence_masks_threshold(T(score), 0.8, has_dustbin=dustbin),
              _jit(JC.correspondence_masks_threshold, threshold=0.8,
                   has_dustbin=dustbin)(score), f"dustbin={dustbin}")


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_top_k_correspondences(largest, ties):
    score = np.random.RandomState(3).randn(6, 7).astype(np.float32)
    if ties:
        score = np.round(score, 0)  # few distinct values: order by flat index
    got = TC.top_k_correspondences(T(score), k=10, has_dustbin=True, largest=largest)
    want = _jit(JC.top_k_correspondences, k=10, has_dustbin=True, largest=largest)(score)
    for name, g, w in zip(("ref", "src", "valid", "scores"), got, want):
        _same(g, w, name)
    assert not bool(got[2].all())  # dustbin hits stay in the set, invalid


@pytest.mark.parametrize("mutual,bilateral", [(True, False), (False, True), (False, False)])
def test_masks_from_feats(mutual, bilateral):
    rng = np.random.RandomState(4)
    ref = rng.randn(9, 16).astype(np.float32)
    src = rng.randn(12, 16).astype(np.float32)
    got = TC.correspondence_masks_from_feats(T(ref), T(src), mutual=mutual, bilateral=bilateral)
    want = _jit(JC.correspondence_masks_from_feats, mutual=mutual, bilateral=bilateral)(ref, src)
    _same(got[0], want[0], "mask")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def _dense_inputs(seed=5):
    rng = np.random.RandomState(seed)
    ref_pts = (rng.rand(40, 3) * 10).astype(np.float32)
    src_pts = (rng.rand(35, 3) * 10).astype(np.float32)
    ref_nodes = (rng.rand(5, 3) * 10).astype(np.float32)
    src_nodes = (rng.rand(4, 3) * 10).astype(np.float32)
    corr = np.stack([rng.randint(0, 40, 25), rng.randint(0, 35, 25)], 1).astype(np.int32)
    return rng, ref_pts, src_pts, ref_nodes, src_nodes, corr


@pytest.mark.parametrize("masks", [False, True])
def test_nearest_node_assignment(masks):
    rng, ref_pts, _, ref_nodes, _, _ = _dense_inputs()
    pm = rng.rand(40) > 0.2 if masks else None
    nm = np.array([True, False, True, True, True]) if masks else None
    got = TC.nearest_node_assignment(T(ref_pts), T(ref_nodes), None if pm is None else T(pm),
                                     None if nm is None else T(nm))
    want = jax.jit(JC.nearest_node_assignment)(ref_pts, ref_nodes, pm, nm)
    _same(got[0], want[0], "p2n")
    _same(got[1], want[1], "sizes")


@pytest.mark.parametrize("case", ["plain", "padded", "masked_points"])
def test_dense_to_node_counts_and_scores(case):
    """Sentinel rows (point index past the cloud, a masked point's node m/n)
    drop out of the scatter, as JAX's mode="drop"."""
    rng, ref_pts, src_pts, ref_nodes, src_nodes, corr = _dense_inputs()
    kw_t, kw_j = {}, {}
    if case == "padded":
        corr = np.concatenate([corr, [[40, 0], [0, 35], [3, 4]]]).astype(np.int32)
        mask = np.array([True] * 25 + [True, True, False])
        kw_t, kw_j = dict(corr_mask=T(mask)), dict(corr_mask=mask)
    if case == "masked_points":
        rpm, spm = rng.rand(40) > 0.3, rng.rand(35) > 0.3
        kw_t = dict(ref_point_masks=T(rpm), src_point_masks=T(spm))
        kw_j = dict(ref_point_masks=rpm, src_point_masks=spm)
    got = TC.dense_to_node_correspondences(T(ref_pts), T(src_pts), T(ref_nodes), T(src_nodes),
                                           T(corr), **kw_t)
    want = jax.jit(JC.dense_to_node_correspondences)(ref_pts, src_pts, ref_nodes, src_nodes,
                                                     corr, **kw_j)
    _same(got[0], want[0], "counts")
    _same(got[1], want[1], "scores")
    assert int(got[0].sum()) > 0


def _patch_setup(seed=6, m=4, n=3, k=5, npts=30):
    rng = np.random.RandomState(seed)
    ref_pts = (rng.rand(npts, 3) * 4).astype(np.float32)
    t = _rigid(seed)
    src_pts = ((ref_pts[rng.permutation(npts)] - t[:3, 3]) @ t[:3, :3]).astype(np.float32)
    rki = rng.randint(0, npts, (m, k)).astype(np.int32)
    ski = rng.randint(0, npts, (n, k)).astype(np.int32)
    rkm = rng.rand(m, k) > 0.2
    skm = rng.rand(n, k) > 0.2
    rki[~rkm] = npts  # masked slots carry the sentinel
    ski[~skm] = npts
    rkp, skp = ref_pts[np.minimum(rki, npts - 1)], src_pts[np.minimum(ski, npts - 1)]
    node_corr = np.stack([rng.randint(0, m, 6), rng.randint(0, n, 6)], 1).astype(np.int32)
    node_corr[-1] = [m + 2, n + 5]  # out of range: clipped, as jnp.take(mode="clip")
    return ref_pts, src_pts, rkp, skp, rki, ski, rkm, skm, node_corr, t


@pytest.mark.parametrize("with_masks", [False, True])
def test_node_to_dense(with_masks):
    _, _, rkp, skp, rki, ski, rkm, skm, node_corr, t = _patch_setup()
    ncm = np.array([True, True, False, True, True, True])
    kw_t = dict(node_corr_mask=T(ncm))
    kw_j = dict(node_corr_mask=ncm)
    if with_masks:
        kw_t.update(ref_knn_masks=T(rkm), src_knn_masks=T(skm))
        kw_j.update(ref_knn_masks=rkm, src_knn_masks=skm)
    got = TC.node_to_dense_correspondences(T(rkp), T(skp), T(rki), T(ski), T(node_corr), T(t),
                                           0.8, **kw_t)
    want = _jit(JC.node_to_dense_correspondences, matching_radius=0.8)(
        rkp, skp, rki, ski, node_corr, t, **kw_j)
    for name, g, w in zip(("corr", "ref_idx", "src_idx", "dist"), got, want):
        _same(g, w, name)
    assert bool(got[0].any())


def test_node_pair_overlaps():
    _, _, rkp, skp, _, _, rkm, skm, _, t = _patch_setup(seed=7, m=3, n=3)
    _same(TC.node_pair_overlaps(T(rkp), T(skp), T(t), 1.0, T(rkm), T(skm)),
          _jit(JC.node_pair_overlaps, pos_radius=1.0)(rkp, skp, t, ref_knn_masks=rkm,
                                                      src_knn_masks=skm), "masked")
    _same(TC.node_pair_overlaps(T(rkp), T(skp), T(t), 1.0),
          _jit(JC.node_pair_overlaps, pos_radius=1.0)(rkp, skp, t), "unmasked")


@pytest.mark.parametrize("seed", [8, 9])
def test_node_overlap_and_occlusion_ratios(seed):
    """The flags' scatter-max covers the sentinel slot num_points (the masked
    slots' index) as JAX's buffer of num_points + 1 does."""
    ref_pts, src_pts, rkp, skp, rki, ski, rkm, skm, node_corr, t = _patch_setup(seed=seed)
    args_t = (len(ref_pts), len(src_pts), T(rkp), T(skp), T(rki), T(ski), T(node_corr), T(t),
              0.9, T(rkm), T(skm))
    static = dict(num_ref_points=len(ref_pts), num_src_points=len(src_pts), matching_radius=0.9)
    arrays = dict(ref_knn_points=rkp, src_knn_points=skp, ref_knn_indices=rki,
                  src_knn_indices=ski, node_corr_indices=node_corr, transform=t,
                  ref_knn_masks=rkm, src_knn_masks=skm)
    want = _jit(JC.node_overlap_ratios, **static)(**arrays)
    want_occ = _jit(JC.node_occlusion_ratios, **static)(**arrays)
    got = TC.node_overlap_ratios(*args_t)
    got_occ = TC.node_occlusion_ratios(*args_t)
    for g, w in zip(got + got_occ, tuple(want) + tuple(want_occ)):
        _same(g, w)
    assert float(got[0].sum()) > 0


# ---------------------------------------------------------------- point matching

@pytest.mark.parametrize("mutual,dustbin", [(False, True), (True, True), (False, False)])
def test_point_matching(mutual, dustbin):
    rng = np.random.RandomState(10)
    p, k = 6, 8
    rkp = rng.randn(p, k, 3).astype(np.float32)
    skp = rng.randn(p, k, 3).astype(np.float32)
    rkm = rng.rand(p, k) > 0.2
    skm = rng.rand(p, k) > 0.2
    scores = (rng.randn(p, k + 1, k + 1) * 2 - 3).astype(np.float32)
    valid = np.array([True, True, False, True, True, True])
    jc = jcfg.FineMatchingConfig(topk=2, mutual=mutual, use_dustbin=dustbin,
                                 confidence_threshold=0.02)
    tc = tcfg.FineMatchingConfig(topk=2, mutual=mutual, use_dustbin=dustbin,
                                 confidence_threshold=0.02)
    got = tpm.point_matching(T(rkp), T(skp), T(rkm), T(skm), T(scores), T(valid), tc)
    want = _jit(jpm.point_matching, cfg=jc)(rkp, skp, rkm, skm, scores, valid)
    for name in ("ref_points", "src_points", "scores", "patch_ids"):
        _same(getattr(got, name), getattr(want, name), name)
    assert int((got.scores > 0).sum()) > 0


@pytest.mark.parametrize("k", [8, 300])
def test_group_and_aggregate(k):
    """k = 300 is past the CUDA kernel's 256; the CPU has no limit."""
    rng = np.random.RandomState(11)
    q = (rng.rand(64, 3) * 6).astype(np.float32)
    s = (rng.rand(400, 3) * 6).astype(np.float32)
    s[390:] = 1e9  # pad rows
    feats = rng.randn(400, 5).astype(np.float32)
    q[0] = 500.0  # a query without neighbours pools to 0
    before = launch_counts()
    got = tpm.group_and_aggregate(T(q), T(s), T(feats), torch.tensor(390, dtype=torch.int32),
                                  4.0, k)
    assert launch_counts() == before  # CPU tensors never reach a kernel
    want = _jit(jpm.group_and_aggregate, radius=4.0, k=k)(q, s, feats, jnp.int32(390))
    _same(got[0], want[0], "pooled")
    _same(got[1], want[1], "sizes")
    assert int(got[1][0]) == 0 and int(got[1].max()) > (8 if k == 8 else 256) - 1
