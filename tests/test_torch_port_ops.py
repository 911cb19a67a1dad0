"""Modules of the PyTorch port against their JAX twins, on the CPU.

Inputs come from numpy seeds; weights are flax inits carried across with
``params_from_jax``. Index outputs are compared exactly. Float outputs at
rtol/atol 1e-4: float32 on both sides, summed in another order.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu import config as jcfg
from rdmnet_tpu.data import procedural as jproc
from rdmnet_tpu.nn import kpconv as jkp
from rdmnet_tpu.nn.kernel_points import make_kernel_points as jax_kernel_points
from rdmnet_tpu.nn.matching import superpoint_matching as jax_matching
from rdmnet_tpu.nn.thdroformer import ThDRoFormer as JaxThDRoFormer
from rdmnet_tpu.nn.vote import VoteLayer as JaxVote
from rdmnet_tpu.ops import geometry as jgeo
from rdmnet_tpu.ops.grid_subsample import grid_subsample as jax_grid_subsample
from rdmnet_tpu.ops.lgr import local_to_global_registration as jax_lgr
from rdmnet_tpu.ops.nms import greedy_nms as jax_nms
from rdmnet_tpu.ops.partition import point_to_node_partition as jax_partition
from rdmnet_tpu.ops.procrustes import weighted_procrustes as jax_procrustes
from rdmnet_tpu_torch import config as tcfg
from rdmnet_tpu_torch.data import procedural as tproc
from rdmnet_tpu_torch.data.loader import choose_bucket
from rdmnet_tpu_torch.nn import kpconv as tkp
from rdmnet_tpu_torch.nn.kernel_points import make_kernel_points
from rdmnet_tpu_torch.nn.matching import superpoint_matching
from rdmnet_tpu_torch.nn.thdroformer import ThDRoFormer
from rdmnet_tpu_torch.nn.vote import VoteLayer
from rdmnet_tpu_torch.ops import geometry as tgeo
from rdmnet_tpu_torch.ops.grid_subsample import grid_subsample
from rdmnet_tpu_torch.ops.lgr import local_to_global_registration
from rdmnet_tpu_torch.ops.nms import greedy_nms
from rdmnet_tpu_torch.ops.partition import point_to_node_partition
from rdmnet_tpu_torch.ops.procrustes import weighted_procrustes
from rdmnet_tpu_torch.utils.convert import params_from_jax

T = torch.from_numpy
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rotation(rng, max_angle=0.5):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-max_angle, max_angle)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k).astype(np.float32)


@pytest.fixture(scope="module")
def scan():
    """One procedural LiDAR scan (sensor frame), the port's twin generator."""
    scans, _ = tproc.procedural_sequence(21, 1, n_rings=24, n_azimuths=400)
    return scans[0][:, :3]


# ---------------------------------------------------------------- host copies

def test_config_twin_matches_jax():
    for jc, tc in [(jcfg.make_cfg(), tcfg.make_cfg()), (jcfg.make_tiny_cfg(), tcfg.make_tiny_cfg()),
                   (jcfg.make_parity_cfg(), tcfg.make_parity_cfg())]:
        for field in dataclasses.fields(tc):
            if field.name == "seed":
                assert tc.seed == jc.seed
                continue
            tsub, jsub = getattr(tc, field.name), getattr(jc, field.name)
            for f in dataclasses.fields(tsub):
                assert getattr(tsub, f.name) == getattr(jsub, f.name), (field.name, f.name)
    tb, jb = tcfg.make_cfg().pyramid.scaled(0.7), jcfg.make_cfg().pyramid.scaled(0.7)
    assert tb.caps == jb.caps == (21504, 8704, 3584, 1280, 512)
    assert tb.band_caps == jb.band_caps == (5120, 2560, 1664, None, None)
    assert [tb.band_chunk_for(i) for i in range(5)] == [jb.band_chunk_for(i) for i in range(5)]
    assert choose_bucket(20524, [21504, 30720]) == 0 and choose_bucket(40000, [21504, 30720]) == 1
    with pytest.raises(ValueError):
        tcfg.make_cfg(pyramid=tcfg.PyramidConfig(voxel_size=0.25))


def test_procedural_twin_matches_jax():
    t_scans, t_poses = tproc.procedural_sequence(5, 2, n_rings=12, n_azimuths=150, enrich=True)
    j_scans, j_poses = jproc.procedural_sequence(5, 2, n_rings=12, n_azimuths=150, enrich=True)
    np.testing.assert_array_equal(t_poses, j_poses)
    for a, b in zip(t_scans, j_scans):
        np.testing.assert_array_equal(a, b)


def test_kernel_points_match_jax():
    for radius, k in [(1.275, 15), (2.55, 15), (1.0, 9)]:
        np.testing.assert_array_equal(make_kernel_points(radius, k),
                                      np.asarray(jax_kernel_points(radius, k)))


# ------------------------------------------------------------------ geometry

def test_pairwise_sq_dist_exact_and_transforms(scan):
    x, y = scan[:300], scan[200:700]
    want = np.asarray(jax.jit(jgeo.pairwise_sq_dist)(x, y))
    np.testing.assert_array_equal(tgeo.pairwise_sq_dist(T(x), T(y)).numpy(), want)
    rng = np.random.RandomState(1)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3], tf[:3, 3] = _rotation(rng), rng.randn(3)
    np.testing.assert_allclose(tgeo.apply_transform(T(x), T(tf)).numpy(),
                               np.asarray(jgeo.apply_transform(x, tf)), **TOL)
    np.testing.assert_allclose(tgeo.inverse_transform(T(tf)).numpy(),
                               np.asarray(jgeo.inverse_transform(tf)), **TOL)


def test_take_padded_sentinel_rows():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([[0, 4, 2], [9, 3, 1]], np.int32)
    np.testing.assert_array_equal(tgeo.take_padded(T(x), T(idx), 7.0).numpy(),
                                  np.asarray(jgeo.take_padded(x, idx, 7.0)))


@pytest.mark.parametrize("voxel,cap", [(0.6, 4096), (1.2, 256), (4.8, 1024)])
def test_grid_subsample_matches_jax(scan, voxel, cap):
    n = len(scan)
    pts = np.full((n + 64, 3), 1e9, np.float32)
    pts[:n] = scan
    want = jax.jit(lambda p: jax_grid_subsample(p, jnp.int32(n), voxel, cap,
                                                return_dropped=True))(pts)
    got = grid_subsample(T(pts)[None], torch.tensor([n], dtype=torch.int32), voxel, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_banded_pyramid_matches_jax():
    """Both pyramids of a pair at a scaled default bucket, where levels 0-2
    take the banded search: every table and ``dropped`` equal."""
    from rdmnet_tpu.graph.pyramid import build_pair_batch as jax_build
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch

    jspec = dataclasses.replace(jcfg.make_cfg().pyramid.scaled(0.1), approx_recall=None)
    tspec = tcfg.make_cfg().pyramid.scaled(0.1)
    assert tspec.band_caps[:3] == (768, 384, 256)
    ref, src, _ = tproc.procedural_pair(31, n_rings=16, n_azimuths=400)
    cap = tspec.caps[0]
    clouds = []
    for pts in (ref, src):
        padded = np.full((cap, 3), 1e9, np.float32)
        n = min(len(pts), cap)
        padded[:n] = pts[:n]
        clouds += [padded, np.int32(n)]
    jb = jax.jit(lambda *a: jax_build(*a, jnp.eye(4), jspec))(*clouds)
    tb = build_pair_batch(*[torch.as_tensor(c) for c in clouds], torch.eye(4), tspec)
    for side in ("ref", "src"):
        jp, tp = getattr(jb, side), getattr(tb, side)
        for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
            for lvl, (j, t) in enumerate(zip(getattr(jp, field), getattr(tp, field))):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"{field}[{lvl}]")
        np.testing.assert_array_equal(tp.dropped.numpy(), np.asarray(jp.dropped))


# ------------------------------------------------------------- coarse stage

def test_greedy_nms_keep_masks_identical(scan):
    rng = np.random.RandomState(2)
    nodes = np.stack([scan[rng.permutation(len(scan))[:96]] for _ in range(2)])
    mask = rng.rand(2, 96) > 0.1
    got, rounds = greedy_nms(T(nodes), T(mask), 2.4)
    got_lim, _ = greedy_nms(T(nodes), T(mask), 6.0, neighbor_limit=4)
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jax.jit(lambda n, m: jax_nms(n, m, 2.4))(nodes[b], mask[b])))
        np.testing.assert_array_equal(
            got_lim[b].numpy(),
            np.asarray(jax.jit(lambda n, m: jax_nms(n, m, 6.0, neighbor_limit=4))(nodes[b], mask[b])))
    assert 1 <= rounds < 96


def test_partition_matches_jax(scan):
    rng = np.random.RandomState(3)
    points = scan[:800]
    points_mask = np.arange(800) < 760
    nodes = points[rng.permutation(760)[:40]] + rng.randn(40, 3).astype(np.float32) * 0.3
    nodes_mask = rng.rand(40) > 0.2
    want = jax.jit(lambda *a: jax_partition(*a, 16))(points, points_mask, nodes, nodes_mask)
    got = point_to_node_partition(T(points), T(points_mask), T(nodes), T(nodes_mask), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_superpoint_matching_matches_jax():
    rng = np.random.RandomState(4)
    ref = rng.randn(48, 32).astype(np.float32)
    src = rng.randn(40, 32).astype(np.float32)
    ref /= np.linalg.norm(ref, axis=1, keepdims=True)
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    rm, sm = rng.rand(48) > 0.3, rng.rand(40) > 0.3
    want = jax.jit(lambda *a: jax_matching(*a, 64))(ref, src, rm, sm)
    got = superpoint_matching(T(ref), T(src), T(rm), T(sm), 64)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)


# --------------------------------------------------------------------- pose

def test_weighted_procrustes_matches_jax():
    rng = np.random.RandomState(5)
    src = (rng.randn(4, 50, 3) * 10).astype(np.float32)
    rot, t = _rotation(rng), rng.randn(3).astype(np.float32)
    ref = src @ rot.T + t + rng.randn(4, 50, 3).astype(np.float32) * 0.01
    w = rng.rand(4, 50).astype(np.float32)
    w[3] = 0.0  # degenerate: identity
    want = np.asarray(jax.jit(jax_procrustes)(src, ref, w))
    got = weighted_procrustes(T(src), T(ref), T(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[3], np.eye(4), atol=1e-6)


@pytest.mark.parametrize("options", [
    {}, {"mutual": True}, {"use_dustbin": False}, {"topk": 2}, {"topk": 2, "mutual": True},
    {"correspondence_limit": 64}, {"use_global_score": True},
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_lgr_matches_jax(options):
    """Well-conditioned patches: every patch sees the same rigid motion.
    Every LGR option of ``FineMatchingConfig`` the JAX package offers."""
    rng = np.random.RandomState(6)
    p, k = 12, 16
    src = (rng.randn(p, k, 3) * 3 + rng.randn(p, 1, 3) * 20).astype(np.float32)
    rot, t = _rotation(rng, 0.3), np.array([2.0, -1.0, 0.5], np.float32)
    ref = (src @ rot.T + t + rng.randn(p, k, 3) * 0.02).astype(np.float32)
    perm = np.stack([rng.permutation(k) for _ in range(p)])
    ref = np.take_along_axis(ref, perm[..., None], axis=1)
    logits = rng.randn(p, k + 1, k + 1).astype(np.float32) - 4.0
    for i in range(p):
        logits[i, np.arange(k), perm[i]] += 6.0  # ref slot j holds the match of src perm[j]
    logits[:, :3, k] = logits[:, k, :3] = 3.0  # dustbin outranks the match on some rows/cols
    rm, sm = rng.rand(p, k) > 0.1, rng.rand(p, k) > 0.1
    cv = np.arange(p) < 10
    node_scores = rng.rand(p).astype(np.float32)
    cfg_j = jcfg.FineMatchingConfig(**options)
    cfg_t = tcfg.FineMatchingConfig(**options)
    jcorr, jtf = jax.jit(lambda *a: jax_lgr(*a[:6], cfg_j, node_corr_scores=a[6]))(
        ref, src, rm, sm, logits, cv, node_scores)
    tcorr, ttf = local_to_global_registration(T(ref), T(src), T(rm), T(sm), T(logits), T(cv),
                                              cfg_t, node_corr_scores=T(node_scores))
    np.testing.assert_allclose(tcorr.scores.numpy(), np.asarray(jcorr.scores), **TOL)
    np.testing.assert_array_equal(tcorr.ref_points.numpy(), np.asarray(jcorr.ref_points))
    np.testing.assert_array_equal(tcorr.src_points.numpy(), np.asarray(jcorr.src_points))
    np.testing.assert_array_equal(tcorr.patch_ids.numpy(), np.asarray(jcorr.patch_ids))
    np.testing.assert_allclose(ttf.numpy(), np.asarray(jtf), **TOL)
    np.testing.assert_allclose(ttf.numpy()[:3, :3], rot, atol=1e-2)


# ------------------------------------------------------------ learned blocks

def _flax_to_torch(jmod, tmod, *args):
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)
    tmod.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return variables


@pytest.mark.parametrize("strided", [False, True])
def test_residual_block_matches_jax(strided):
    rng = np.random.RandomState(7)
    n_s, n_q, h, cin, cout = 120, 60 if strided else 120, 10, 32, 64
    s_pts = (rng.rand(n_s, 3) * 4).astype(np.float32)
    q_pts = s_pts[:n_q] + 0.05
    nbr = rng.randint(0, n_s + 1, size=(n_q, h)).astype(np.int32)  # n_s = sentinel
    feats = rng.randn(n_s, cin).astype(np.float32)
    qm, sm = np.arange(n_q) < n_q - 5, np.arange(n_s) < n_s - 5
    args = (feats, q_pts, s_pts, nbr, qm, sm)
    jm = jkp.ResidualBlock(cin, cout, 15, 1.275, 0.6, 8, strided=strided)
    tm = tkp.ResidualBlock(cin, cout, 15, 1.275, 0.6, 8, strided=strided)
    variables = _flax_to_torch(jm, tm, *args)
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    with torch.no_grad():
        got = tm(*[T(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_conv_block_ones_input_matches_jax():
    rng = np.random.RandomState(8)
    n, h = 100, 12
    pts = (rng.rand(n, 3) * 4).astype(np.float32)
    nbr = rng.randint(0, n + 1, size=(n, h)).astype(np.int32)
    mask = np.arange(n) < 90
    feats = mask[:, None].astype(np.float32)
    nbr_feats = (nbr < 90)[..., None].astype(np.float32)
    jm = jkp.ConvBlock(1, 32, 15, 1.275, 0.6, 8)
    tm = tkp.ConvBlock(1, 32, 15, 1.275, 0.6, 8)
    variables = _flax_to_torch(jm, tm, feats, pts, pts, nbr, mask)
    want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, nbr_feats=nbr_feats))(
        variables, feats, pts, pts, nbr, mask))
    with torch.no_grad():
        got = tm(T(feats), T(pts), T(pts), T(nbr), T(mask), nbr_feats=T(nbr_feats)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_thdroformer_matches_jax():
    rng = np.random.RandomState(9)
    n, m = 40, 32
    args = ((rng.rand(n, 3) * 30).astype(np.float32), (rng.rand(m, 3) * 30).astype(np.float32),
            rng.randn(n, 64).astype(np.float32), rng.randn(m, 64).astype(np.float32),
            rng.rand(n) > 0.2, rng.rand(m) > 0.2)
    jm = JaxThDRoFormer(64, 48, 32, 4, 2)
    tm = ThDRoFormer(64, 48, 32, 4, 2)
    variables = _flax_to_torch(jm, tm, *args)
    want = jax.jit(jm.apply)(variables, *args)
    with torch.no_grad():
        got = tm(*[T(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_vote_layer_matches_jax():
    rng = np.random.RandomState(10)
    xyz = (rng.rand(2, 30, 3) * 20).astype(np.float32)
    feats = (rng.randn(2, 30, 16) * 3).astype(np.float32)
    vc = jcfg.VoteConfig(mlps=(24, 12), max_translate_range=(0.5, 0.4, 0.3))
    jm = JaxVote(vc, 16)
    tm = VoteLayer(tcfg.VoteConfig(mlps=(24, 12), max_translate_range=(0.5, 0.4, 0.3)), 16)
    variables = _flax_to_torch(jm, tm, xyz, feats)
    want = jax.jit(jm.apply)(variables, xyz, feats)
    with torch.no_grad():
        got = tm(T(xyz), T(feats))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------- isolation

def test_port_imports_no_jax():
    """Every module of the port imports without JAX, flax or rdmnet_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rdmnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(rdmnet_tpu_torch.__path__, 'rdmnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'rdmnet_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('nn.transformers', 'nn.geotransformer', 'utils.torch_convert', 'cli.convert',\n"
        "          'cli.test_sweep'):\n"
        "    assert 'rdmnet_tpu_torch.' + m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith('rdmnet_tpu_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25


def test_entry_points_default_to_cuda():
    from rdmnet_tpu_torch.device import resolve_device
    from rdmnet_tpu_torch.models import RDMNet, pipeline

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = tcfg.make_tiny_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        RDMNet(cfg)
    model = RDMNet(cfg, device="cpu")
    pts = torch.zeros((512, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline(model, pts, 10, pts, 10)
