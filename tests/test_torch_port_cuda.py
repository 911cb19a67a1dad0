"""CUDA kernels of the port against their plain PyTorch versions, and the
training, serving and evaluation paths against the CPU's, on the card; every
path of each kernel (the kNN's register list and, for k > 256, its warp and
block select paths; Sinkhorn's register patch, its cluster path for 208 < K1
<= 546 and its group path past that, whose bands spill past K1 = 2640) and
the model at such shapes; the serving program: the port's own kernels
against their plain versions (segment sums bit-equal, NMS keep masks and
rounds equal, eigh4's rotation within 1e-5 of ``torch.linalg.eigh``'s on
well-conditioned fits), ``pipeline`` with no host sync, each bucket's
captured program against the eager pipeline on requests that rise and fall
in size, and eight HTTP clients at once against captured programs; the
Trainer's programs: the captured train step (grad_acc_steps 1 and 2, a NaN
step among them) and eval step bit-equal to the eager steps, and a Trainer
on its programs against one kept eager.

Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest configures JAX). Every test skips
on a host without a CUDA device. Tolerances: radius kNN indices exact (the
kernel rounds distances exactly as the plain version does and keeps the
(distance, index) order, ties included), Sinkhorn at rtol/atol 1e-4 (float32
sums in another order, approximate exp2/log2); a tiny-config train step on
the card against the CPU's with the tolerances of ``test_torch_port_train.py``
(losses 1e-4; gradient norms per tensor 1e-2 of the tensor's plus 1e-6 of
the global norm, 2e-3 globally; parameters after the step 1e-7 where the
gradient stands clear of float noise, else within one step of lr).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from rdmnet_tpu_torch.cli.test import run_eval_loop
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset, write_procedural_root
from rdmnet_tpu_torch.data.loader import PairLoader
from rdmnet_tpu_torch.engine import Trainer
from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager, state_to_host
from rdmnet_tpu_torch.data.procedural import procedural_pair, procedural_sequence
from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
from rdmnet_tpu_torch.graph.pyramid import pad_cloud
from rdmnet_tpu_torch.models import RDMNet, pipeline
from rdmnet_tpu_torch.ops.kernels import launch_counts, path_launch_counts, reset_launch_counts
from rdmnet_tpu_torch.ops.kernels.radius_knn import (BLOCK_K_MIN, SELECT_BOX_ROWS_MAX,
                                                     WINDOW_ROWS_MAX, knn_plan, radius_knn_cuda,
                                                     radius_knn_plain)
from rdmnet_tpu_torch.ops.kernels import sinkhorn as sinkhorn_module
from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda, sinkhorn_plain, sinkhorn_plan
from rdmnet_tpu_torch.ops.radius_search import band_windows
from rdmnet_tpu_torch.ops.ransac import ransac_registration, ransac_registration_host
from rdmnet_tpu_torch.serving import export_inference, load_exported

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _lidar_like(seed, n, scale=(70.0, 30.0, 3.0)):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * np.asarray(scale) - np.asarray(scale) / 2).astype(np.float32)
    return pts[np.argsort(np.floor(pts[:, 0] / 0.6), kind="stable")]


def _duplicated(seed, n, scale=(70.0, 30.0, 3.0)):
    """Every point twice, as rows 2i-1 and 2i: exact distance ties between
    neighbouring lanes, across 32-row steps and across tiles (7168 is even)."""
    return _lidar_like(seed, n // 2 + 1, scale)[(np.arange(n) + 1) // 2]


def test_sinkhorn_kernel_matches_plain(cuda):
    rng = np.random.RandomState(9)
    p, k1 = 32, 129
    s = (rng.randn(p, k1, k1) * 3).astype(np.float32)
    mu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    nu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    s[0], mu[0, :-1], nu[0, :-1] = -1e12, -1e12, -1e12
    s[1, :9], mu[1, :9] = -1e12, -1e12
    args = [torch.from_numpy(x).to(cuda) for x in (s, mu, nu)]
    got = sinkhorn_cuda(*args, 100)
    torch.cuda.synchronize()
    want = sinkhorn_plain(*args, 100)
    live = want > -1e11
    assert torch.equal(got > -1e11, live)
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,band,chunk", [(40, None, 0), (1, None, 0), (40, 1024, 512),
                                          (16, 768, 192)])
def test_radius_knn_kernel_matches_plain(cuda, k, band, chunk):
    pts = torch.from_numpy(np.stack([_lidar_like(10, 4096), _lidar_like(11, 4096)])).to(cuda)
    cnt = torch.tensor([4000, 4096], dtype=torch.int32, device=cuda)
    kw = {}
    if band is not None:
        win, _ = band_windows(pts, pts, cnt, 1.275, 0.6, band, chunk)
        kw = dict(win=win, chunk=chunk, band=band)
    got = radius_knn_cuda(pts, pts, cnt, 1.275, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, radius_knn_plain(pts, pts, cnt, 1.275, k, **kw))


@pytest.mark.parametrize("k1", [17, 65, 129, 200, 209, 257, 513, 600, 2641])
def test_sinkhorn_kernel_masks_at_every_size(cuda, k1):
    """Masked rows, masked columns, both, and a fully masked patch at every
    register layout of the kernel (K1 <= 32, 80, 144, 208), on its cluster
    path (208 < K1 <= 546) and its group path, whose bands spill from the
    first K1 past 2640."""
    rng = np.random.RandomState(k1)
    p = 12
    s = (rng.randn(p, k1, k1) * 3).astype(np.float32)
    mu = np.full((p, k1), -np.log(2 * (k1 - 1)), np.float32)
    nu = mu.copy()
    s[0], mu[0, :-1], nu[0, :-1] = -1e12, -1e12, -1e12
    rows, cols = slice(0, k1 // 4), slice(2, 2 + k1 // 5)
    s[1, rows], mu[1, rows] = -1e12, -1e12
    s[2, :, cols], nu[2, cols] = -1e12, -1e12
    s[3, rows], mu[3, rows], s[3, :, cols], nu[3, cols] = -1e12, -1e12, -1e12, -1e12
    args = [torch.from_numpy(x).to(cuda) for x in (s, mu, nu)]
    reset_launch_counts()
    got = sinkhorn_cuda(*args, 100)
    torch.cuda.synchronize()
    route = "register" if k1 <= 208 else "cluster" if k1 <= 546 else "group"
    assert sinkhorn_plan(k1).route == route
    assert (sinkhorn_plan(k1).spill_rows > 0) == (k1 > 2640)
    assert path_launch_counts()["sinkhorn"] == {"register": 0, "cluster": 0, "group": 0,
                                                route: 1}
    want = sinkhorn_plain(*args, 100)
    live = want > -1e11
    assert torch.isfinite(got).all()
    assert torch.equal(got > -1e11, live)
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k1", [209, 257, 304, 305, 412, 413, 513, 546])
@pytest.mark.parametrize("iters", [0, 1, 100])
def test_cluster_sinkhorn_matches_plain(cuda, k1, iters):
    """The cluster path at each cluster size's first and last K1 (2 CTAs a
    patch to 304, 4 to 412, 8 to 546): masked rows, masked columns, both, a
    fully masked patch, and no iteration at all (the scores come back)."""
    plan = sinkhorn_plan(k1)
    assert plan.route == "cluster"
    assert plan.cluster == (2 if k1 <= 304 else 4 if k1 <= 412 else 8)
    rng = np.random.RandomState(k1 + iters)
    p = 10
    s = (rng.randn(p, k1, k1) * 3).astype(np.float32)
    mu = (rng.randn(p, k1) * 0.1 - np.log(k1)).astype(np.float32)
    nu = (rng.randn(p, k1) * 0.1 - np.log(k1)).astype(np.float32)
    s[0], mu[0, :-1], nu[0, :-1] = -1e12, -1e12, -1e12
    rows, cols = slice(0, k1 // 3), slice(5, 5 + k1 // 4)  # rows across the first CTA's band
    s[1, rows], mu[1, rows] = -1e12, -1e12
    s[2, :, cols], nu[2, cols] = -1e12, -1e12
    s[3, rows], mu[3, rows], s[3, :, cols], nu[3, cols] = -1e12, -1e12, -1e12, -1e12
    s[4, k1 - 7:], mu[4, k1 - 7:] = -1e12, -1e12  # the last CTA's band
    args = [torch.from_numpy(x).to(cuda) for x in (s, mu, nu)]
    reset_launch_counts()
    got = sinkhorn_cuda(*args, iters)
    torch.cuda.synchronize()
    assert path_launch_counts()["sinkhorn"] == {"register": 0, "cluster": 1, "group": 0}
    want = sinkhorn_plain(*args, iters)
    live = want > -1e11
    assert torch.isfinite(got).all()
    assert torch.equal(got > -1e11, live)
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)


def test_cluster_sinkhorn_raises_when_no_cluster_fits(cuda, monkeypatch):
    """A cluster the card cannot schedule raises; the call takes no other
    path and counts no launch."""
    monkeypatch.setattr(sinkhorn_module, "_launcher",
                        lambda route: lambda *args: sinkhorn_module.NO_CLUSTER)
    x = torch.zeros((1, 257, 257), device=cuda)
    mu = torch.zeros((1, 257), device=cuda)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no cluster of 2 CTAs"):
        sinkhorn_cuda(x, mu, mu, 10)
    assert path_launch_counts()["sinkhorn"] == {"register": 0, "cluster": 0, "group": 0}


def test_cluster_occupancy_is_positive(cuda):
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import cluster_occupancy

    for k1 in (257, 412, 546):
        assert cluster_occupancy(k1) >= 1


def _group_inputs(seed, p, k1):
    """A fully masked patch, masked rows, masked columns, both, and the last
    CTA's rows masked, as far as P allows; the last patch is left whole."""
    rng = np.random.RandomState(seed)
    s = (rng.randn(p, k1, k1) * 3).astype(np.float32)
    mu = (rng.randn(p, k1) * 0.1 - np.log(k1)).astype(np.float32)
    nu = (rng.randn(p, k1) * 0.1 - np.log(k1)).astype(np.float32)
    rows, cols = slice(0, k1 // 3), slice(5, 5 + k1 // 4)  # rows across the first CTA's band
    if p > 1:
        s[0], mu[0, :-1], nu[0, :-1] = -1e12, -1e12, -1e12
    if p > 2:
        s[1, rows], mu[1, rows] = -1e12, -1e12
    if p > 3:
        s[2, :, cols], nu[2, cols] = -1e12, -1e12
    if p > 4:
        s[3, rows], mu[3, rows], s[3, :, cols], nu[3, cols] = -1e12, -1e12, -1e12, -1e12
    if p > 5:
        s[4, k1 - 7:], mu[4, k1 - 7:] = -1e12, -1e12  # the last CTA's band
    return [torch.from_numpy(x).to(torch.device("cuda")) for x in (s, mu, nu)]


def _held_against_plain(args, iters, route):
    reset_launch_counts()
    got = sinkhorn_cuda(*args, iters)
    torch.cuda.synchronize()
    assert path_launch_counts()["sinkhorn"] == {"register": 0, "cluster": 0, "group": 0,
                                                route: 1}
    want = sinkhorn_plain(*args, iters)
    live = want > -1e11
    assert torch.isfinite(got).all()
    assert torch.equal(got > -1e11, live)
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k1", [547, 600, 1025, 2640, 2641, 3000, 4096])
@pytest.mark.parametrize("iters", [0, 1, 100])
def test_group_sinkhorn_matches_plain(cuda, k1, iters):
    """The group path at its first K1 (6 CTAs a patch), at 600 (7), 1025 (20)
    and its last K1 held whole in shared memory, 2640 (132 CTAs, one an SM),
    then with spilled rows: 2641 (126 CTAs of 21 rows, 1 of them read from
    device memory), 3000 (131 of 23, 5) and 4096 (128 of 32, 19): masked
    rows, columns, both, whole patches, and no iteration at all (the scores
    come back)."""
    plan = sinkhorn_plan(k1)
    assert plan.route == "group"
    assert (plan.group, plan.spill_rows) == {547: (6, 0), 600: (7, 0), 1025: (20, 0),
                                             2640: (132, 0), 2641: (126, 1), 3000: (131, 5),
                                             4096: (128, 19)}[k1]
    _held_against_plain(_group_inputs(k1 + iters, 7 if k1 < 2640 else 3, k1), iters, "group")


@pytest.mark.parametrize("k1, p", [(600, 1), (600, 40), (1025, 13), (2640, 2), (2641, 2)])
def test_group_sinkhorn_rounds(cuda, k1, p):
    """One patch, and more patches than the card holds groups at once (18 of
    7 CTAs at K1 = 600, 6 of 20 at 1025, 1 of 132 at 2640, 1 of 126 at 2641),
    so the persistent groups walk the patches in several rounds."""
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import group_resident

    groups = group_resident(k1, cuda.index or 0) // sinkhorn_plan(k1).group
    assert groups >= 1 and (p == 1 or p > groups)
    _held_against_plain(_group_inputs(k1 + p, p, k1), 100, "group")


def test_group_sinkhorn_raises_when_no_group_fits(cuda, monkeypatch):
    """A card that cannot hold one group at once, or a launch refused as
    such, raises; the call takes no other path and counts no launch."""
    x = torch.zeros((2, 600, 600), device=cuda)
    mu = torch.zeros((2, 600), device=cuda)
    monkeypatch.setattr(sinkhorn_module, "group_resident", lambda k1, index: 6)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="cannot hold a group of 7 CTAs"):
        sinkhorn_cuda(x, mu, mu, 10)
    monkeypatch.undo()
    monkeypatch.setattr(sinkhorn_module, "_launcher",
                        lambda route: lambda *args: sinkhorn_module.NO_GROUP)
    with pytest.raises(RuntimeError, match="cannot hold the groups of 7 CTAs"):
        sinkhorn_cuda(x, mu, mu, 10)
    assert path_launch_counts()["sinkhorn"] == {"register": 0, "cluster": 0, "group": 0}


@pytest.mark.parametrize("k", [BLOCK_K_MIN, 2048, 4096, 6144])
@pytest.mark.parametrize("layout", ["banded", "tiled"])
def test_block_select_knn_matches_plain(cuda, k, layout):
    """The block select path, at the k the plan sends it (from
    ``BLOCK_K_MIN``; past 4096 in two sort chunks), on duplicated points
    (distance ties between neighbouring rows): a banded batch of two clouds
    whose s_count ends inside a window, and an unbanded window larger than
    one staged tile and than the key cache (8192 keys), so some queries
    sweep their window again for every pass."""
    if layout == "banded":  # >= 925 rows in radius a query: lists of 4096 fill for 55%
        n, band, chunk, radius = 12000, 8192, 256, 1.5
        s = torch.from_numpy(np.stack([_duplicated(40, n, (4.0, 2.0, 1.5)),
                                       _duplicated(41, n, (4.0, 2.0, 1.5))])).to(cuda)
        cnt = torch.tensor([10000, n], dtype=torch.int32, device=cuda)
        win, _ = band_windows(s, s, cnt, radius, 0.6, band, chunk)
        q, kw = s, dict(win=win, chunk=chunk, band=band)
    else:
        n, radius = 2 * WINDOW_ROWS_MAX + 1000, 2.5
        s = torch.from_numpy(_duplicated(42, n, (6.0, 3.0, 2.0))[None]).to(cuda)
        cnt = torch.tensor([n - 333], dtype=torch.int32, device=cuda)
        q, kw = s[:, ::16].contiguous(), {}
    plan = knn_plan(q.shape[0], q.shape[1], s.shape[1], k, kw.get("band"))
    assert plan.route == "block" and plan.tiled == (layout == "tiled")
    reset_launch_counts()
    got = radius_knn_cuda(q, s, cnt, radius, k, **kw)
    torch.cuda.synchronize()
    assert path_launch_counts()["radius_knn"] == {"list": 0, "select": 0, "block": 1}
    want = radius_knn_plain(q, s, cnt, radius, k, **kw)
    assert torch.equal(got, want)
    if k <= 4096:
        assert ((want < s.shape[1]).sum(-1) == k).any()  # lists that fill


@pytest.mark.parametrize("k", [257, 320, 512, 600, BLOCK_K_MIN - 1])
def test_warp_select_knn_matches_plain(cuda, k):
    """The warp select path, at the k the plan sends it (past the register
    list, below ``BLOCK_K_MIN``), on a dense banded batch of duplicated
    points where many queries hold more in-radius rows than their sort
    buffer (the radix select and the tie count-off run) and s_count ends
    inside a window."""
    n = 6000
    s = torch.from_numpy(np.stack([_duplicated(30, n, (8.0, 2.0, 1.0)),
                                   _duplicated(31, n, (8.0, 2.0, 1.0))])).to(cuda)
    cnt = torch.tensor([5000, n], dtype=torch.int32, device=cuda)
    band, chunk, radius = 4096, 192, 1.5
    win, _ = band_windows(s, s, cnt, radius, 0.6, band, chunk)
    plan = knn_plan(2, n, n, k, band)
    assert plan.route == "select" and plan.sort_rows == 1 << (k - 1).bit_length()
    reset_launch_counts()
    got = radius_knn_cuda(s, s, cnt, radius, k, win=win, chunk=chunk, band=band)
    torch.cuda.synchronize()
    assert path_launch_counts()["radius_knn"] == {"list": 0, "select": 1, "block": 0}
    assert torch.equal(got, radius_knn_plain(s, s, cnt, radius, k, win=win, chunk=chunk,
                                             band=band))
    over = radius_knn_plain(s, s, cnt, radius, plan.sort_rows + 1, win=win, chunk=chunk,
                            band=band)
    assert (over[..., -1] < n).any()  # more candidates than the sort buffer holds


@pytest.mark.parametrize("k", [257, 320, 600, BLOCK_K_MIN - 1])
def test_warp_select_knn_tiled_window_overflows(cuda, k):
    """The warp select path on an unbanded window of duplicated points past
    ``SELECT_BOX_ROWS_MAX`` rows, swept box tile by box tile by the whole
    block, where every query holds more in-radius rows than its sort buffer
    (the radix passes and the collect sweep cross the tiles too)."""
    n = SELECT_BOX_ROWS_MAX + 7000
    s = torch.from_numpy(_duplicated(43, n, (40.0, 3.0, 2.0))[None]).to(cuda)
    q = s[:, ::37].contiguous()
    cnt = torch.tensor([n - 77], dtype=torch.int32, device=cuda)
    plan = knn_plan(1, q.shape[1], n, k)
    assert plan.route == "select" and plan.tiled
    reset_launch_counts()
    got = radius_knn_cuda(q, s, cnt, 3.0, k)
    torch.cuda.synchronize()
    assert path_launch_counts()["radius_knn"] == {"list": 0, "select": 1, "block": 0}
    assert torch.equal(got, radius_knn_plain(q, s, cnt, 3.0, k))
    over = radius_knn_plain(q, s, cnt, 3.0, plan.sort_rows + 1)
    assert (over[..., -1] < n).float().mean() > 0.9  # most queries overflow the buffer


@pytest.mark.parametrize("k", [1, 16, 40, 64, 128, 81, 200, 256, 257, 600, 2048])
def test_radius_knn_kernel_exact_ties_in_tiled_window(cuda, k):
    """Duplicated support points in an unbanded window too large for one
    tile of any path (the list path's staged rows, the warp select path's
    chunk boxes, the block path's key cache); s_count ends inside the last
    tile of cloud 0."""
    n = 2 * SELECT_BOX_ROWS_MAX + 1000
    s = torch.from_numpy(np.stack([_duplicated(20, n), _duplicated(21, n)])).to(cuda)
    q = s[:, ::7].contiguous()
    cnt = torch.tensor([n - 333, n], dtype=torch.int32, device=cuda)
    assert knn_plan(2, q.shape[1], n, k).tiled
    got = radius_knn_cuda(q, s, cnt, 1.275, k)
    torch.cuda.synchronize()
    want = radius_knn_plain(q, s, cnt, 1.275, k)
    assert torch.equal(got, want)
    assert (want[..., :2] < n).all(dim=-1).float().mean() > 0.9  # most rows have a tie pair


@pytest.mark.parametrize("k", [1, 16, 40, 64, 128, 81, 200, 256, 257, 512])
def test_radius_knn_kernel_dense_cluster_banded(cuda, k):
    """More than k in-radius rows per query, banded windows, Q not a multiple
    of the block's query count, s_count ending inside a window, and
    duplicated points."""
    n = 2990
    s = torch.from_numpy(np.stack([_duplicated(30, n, (8.0, 2.0, 1.0)),
                                   _duplicated(31, n, (8.0, 2.0, 1.0))])).to(cuda)
    cnt = torch.tensor([2500, n], dtype=torch.int32, device=cuda)
    band, chunk, radius = 1024, 192, 1.5
    plan = knn_plan(2, n, n, k, band)
    assert n % plan.warps and chunk % plan.warps == 0
    win, _ = band_windows(s, s, cnt, radius, 0.6, band, chunk)
    assert int(win[0, -1]) + band > 2500  # the last windows of cloud 0 hold invalid rows
    got = radius_knn_cuda(s, s, cnt, radius, k, win=win, chunk=chunk, band=band)
    torch.cuda.synchronize()
    want = radius_knn_plain(s, s, cnt, radius, k, win=win, chunk=chunk, band=band)
    assert torch.equal(got, want)
    assert (want < n).all(dim=-1).float().mean() > 0.5  # most queries keep k neighbours


@pytest.mark.parametrize("k", [81, 200, 256, 320, 2048])
@pytest.mark.parametrize("level", [0, 4])
def test_radius_knn_kernel_large_k_at_main_path_shapes(cuda, k, level):
    """The 128- and 256-entry lists and the select path (k = 320, 2048) at
    the 0.7 bucket's level-0 (banded, 21504 rows) and level-4 (512 rows)
    neighbour searches of a ~20k-point procedural scan pair."""
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, search_plan

    pyr = make_cfg().pyramid.scaled(0.7)
    ref, src, _ = procedural_pair(7351, n_rings=80, n_azimuths=3000)
    cap = pyr.caps[0]
    # the pyramid at its own limits (a banded level holds k <= its band cap)
    batch = build_pair_batch(*pad_cloud(ref, cap, device=cuda), *pad_cloud(src, cap, device=cuda),
                             torch.eye(4, device=cuda), pyr)
    sp = next(p for p in search_plan(pyr) if p.table == "neighbors" and p.q_lvl == level)
    pts = torch.stack([batch.ref.points[level], batch.src.points[level]]).contiguous()
    cnt = torch.stack([batch.ref.counts[level], batch.src.counts[level]]).to(torch.int32)
    kw = {}
    if sp.band is not None:
        win, _ = band_windows(pts, pts, cnt, sp.radius, sp.cell, sp.band, sp.chunk)
        kw = dict(win=win, chunk=sp.chunk, band=sp.band)
    plan = knn_plan(2, pts.shape[1], pts.shape[1], k, sp.band)
    assert (plan.k_bucket, plan.sort_rows) == ((128, 0) if k <= 128 else (256, 0) if k <= 256
                                               else (0, min(1 << (k - 1).bit_length(), 2048)))
    assert plan.route == ("list" if k <= 256 else "select" if k < BLOCK_K_MIN else "block")
    reset_launch_counts()
    got = radius_knn_cuda(pts, pts, cnt, sp.radius, k, **kw)
    torch.cuda.synchronize()
    assert path_launch_counts()["radius_knn"][plan.route] == 1
    assert torch.equal(got, radius_knn_plain(pts, pts, cnt, sp.radius, k, **kw))


def test_model_past_the_first_paths_on_card_matches_cpu(cuda):
    """The tiny model with level-0 limit 300 and 256 points a patch, on a
    scan shrunk into a dense scene (the level-0 lists fill past 256): it
    builds on the card, its two level-0 searches take the kNN's warp select
    path and its Sinkhorn the cluster path, its tables equal the CPU's, and its
    plans match the CPU's through the same matched node pairs within 1e-3."""
    cfg = make_tiny_cfg()
    cfg = dataclasses.replace(
        cfg, pyramid=dataclasses.replace(cfg.pyramid, neighbor_limits=(300, 16, 16, 16, 16)),
        model=dataclasses.replace(cfg.model, num_points_in_patch=256))
    ref, src, _ = procedural_pair(3, n_rings=16, n_azimuths=200)
    ref, src = ref[:500] * np.float32(0.08), src[:500] * np.float32(0.08)
    m_gpu = RDMNet(cfg, device=cuda, generator=torch.Generator().manual_seed(1))
    m_cpu = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    out = pipeline(m_gpu, *pad_cloud(ref, 512, device=cuda), *pad_cloud(src, 512, device=cuda),
                   device=cuda)
    assert path_launch_counts() == {"radius_knn": {"list": 10, "select": 2, "block": 0},
                                    "sinkhorn": {"register": 0, "cluster": 1, "group": 0}}
    assert torch.isfinite(out["estimated_transform"]).all()
    ref_out = pipeline(m_cpu, *pad_cloud(ref, 512), *pad_cloud(src, 512), device="cpu")
    for side in ("ref", "src"):
        for field in ("points", "neighbors", "subsampling", "upsampling"):
            for a, b in zip(getattr(getattr(out["batch"], side), field),
                            getattr(getattr(ref_out["batch"], side), field)):
                assert torch.equal(a.cpu(), b)
    assert (out["batch"].ref.neighbors[0][:, 256] < 512).any()
    # node pairs matched on one side only must be near-ties at that side's
    # top-k boundary; the plans agree through the pairs both matched
    m = ref_out["src_node_masks"].shape[0]
    runs = []
    for o in (out, ref_out):
        valid, scores = o["node_corr_valid"].cpu(), o["node_corr_scores"].cpu()
        keys = (o["ref_node_corr_indices"].long().cpu() * m
                + o["src_node_corr_indices"].long().cpu()).tolist()
        runs.append(({k: i for i, k in enumerate(keys) if valid[i]}, scores,
                     float(scores[valid].min())))
    common = sorted(runs[0][0].keys() & runs[1][0].keys())
    for (mine, scores, floor), (other, _, _) in (runs, runs[::-1]):
        for key, i in mine.items():
            assert key in other or float(scores[i]) - floor <= 1e-4 * floor
    assert len(common) >= 4
    got = out["matching_scores"].cpu()[[runs[0][0][k] for k in common]]
    want = ref_out["matching_scores"][[runs[1][0][k] for k in common]]
    live = want > -1e11
    assert got.shape[-1] == 257 and torch.equal(got > -1e11, live)
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-3)


def test_pipeline_on_card_launches_kernels_and_matches_cpu(cuda):
    cfg = make_tiny_cfg()
    ref, src, _ = procedural_pair(3, n_rings=16, n_azimuths=200)
    ref, src = ref[:500], src[:500]
    m_gpu = RDMNet(cfg, device=cuda, generator=torch.Generator().manual_seed(1))
    m_cpu = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    out = pipeline(m_gpu, *pad_cloud(ref, 512, device=cuda), *pad_cloud(src, 512, device=cuda),
                   device=cuda)
    assert launch_counts() == {"radius_knn": 12, "sinkhorn": 1}
    assert torch.isfinite(out["estimated_transform"]).all()
    ref_out = pipeline(m_cpu, *pad_cloud(ref, 512), *pad_cloud(src, 512), device="cpu")
    for side in ("ref", "src"):
        for field in ("points", "neighbors", "subsampling", "upsampling"):
            for a, b in zip(getattr(getattr(out["batch"], side), field),
                            getattr(getattr(ref_out["batch"], side), field)):
                assert torch.equal(a.cpu(), b)


def test_sinkhorn_kernel_refuses_inputs_that_require_grad(cuda):
    s = torch.randn(4, 17, 17, device=cuda, requires_grad=True)
    mu = torch.full((4, 17), -3.0, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        sinkhorn_cuda(s, mu, mu, 10)
    with torch.no_grad():
        assert torch.isfinite(sinkhorn_cuda(s, mu, mu, 10)).all()


def _train_pair(cfg, device):
    """Frames 0 and 1 of a procedural sequence at the tiny capacity, with
    their relative pose: few enough overlapping node pairs that the target
    sample is the whole eligible set on any random stream."""
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    ref = scans[0][rng.permutation(len(scans[0]))[:500], :3]
    src = scans[1][rng.permutation(len(scans[1]))[:480], :3]
    (rp, rc), (sp, sc) = pad_cloud(ref, 512), pad_cloud(src, 512)
    host = {"ref_points": rp.numpy()[None], "ref_counts": rc.numpy()[None],
            "src_points": sp.numpy()[None], "src_counts": sc.numpy()[None],
            "transform": (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)[None]}
    return batch_to_device(host, cfg.pyramid, device=device)


def test_gradient_reaches_alpha_and_n2p_head_through_plain_sinkhorn(cuda):
    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device=cuda, generator=torch.Generator().manual_seed(1))
    batch = _train_pair(cfg, cuda)
    reset_launch_counts()
    out = model(batch[0], training=True, with_gt=True,
                generator=torch.Generator(device=cuda).manual_seed(0))
    assert launch_counts()["sinkhorn"] == 0
    assert out["matching_scores"].requires_grad
    (out["matching_scores"][out["matching_scores"] > -1e11].mean()
     + out["ref_n2p_scores_c"].mean()).backward()
    for p in (model.optimal_transport.alpha, model.proj_n2p_score.weight):
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0


def test_train_step_on_card_matches_cpu(cuda):
    cfg = make_tiny_cfg()
    states, results = [], []
    for dev in (cuda, torch.device("cpu")):
        model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        state = create_train_state(cfg, model)
        batch = _train_pair(cfg, dev)
        with torch.no_grad():
            overlaps = model(batch[0], training=False, with_gt=True)["gt_node_corr_overlaps"]
        assert 0 < int((overlaps > 0.1).sum()) <= cfg.coarse_matching.num_targets
        metrics, grads = make_value_and_grad(cfg, device=dev)(
            state, batch, torch.Generator(device=dev).manual_seed(0))
        params0 = [p.detach().clone() for p in state.params]
        assert state.apply_gradients(grads)
        states.append(state)
        results.append((metrics, [g.cpu() for g in grads], [p.cpu() for p in params0]))
    (m_gpu, g_gpu, p0_gpu), (m_cpu, g_cpu, p0_cpu) = results
    for name, value in m_cpu.items():
        if name != "grad_norm":
            assert abs(float(m_gpu[name]) - float(value)) <= 1e-4, name
    total = torch.sqrt(sum((g * g).sum() for g in g_cpu))
    assert torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(g_gpu, g_cpu))) <= 2e-3 * total
    gmax = max(float(g.abs().max()) for g in g_cpu)
    lr = cfg.optim.lr
    for a, b, g, p0, q0, p_gpu, p_cpu in zip(g_gpu, g_cpu, g_cpu, p0_gpu, p0_cpu,
                                            states[0].params, states[1].params):
        assert torch.equal(p0, q0)
        assert torch.linalg.norm(a - b) <= 1e-2 * torch.linalg.norm(b) + 1e-6 * total
        got, want = p_gpu.detach().cpu(), p_cpu.detach()
        sig = g.abs() > 1e-3 * gmax
        assert not sig.any() or (got - want)[sig].abs().max() <= 1e-7
        assert (got - p0).abs().max() <= lr * (1 + 1e-3)


def test_serve_on_card_matches_cpu(cuda, tmp_path):
    """An artifact of seeded tiny-config weights served on the card and on
    the CPU: a scan against a rigidly moved copy (weights 1 register it)."""
    cfg = make_tiny_cfg()
    small, _, _ = procedural_pair(7353, n_rings=16, n_azimuths=200)
    small = small[np.random.RandomState(0).permutation(len(small))[:500]]
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    moved = ((small - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    export_inference(cfg, model, str(tmp_path), bucket_scales=(0.5, 1.0))
    on_card, _ = load_exported(str(tmp_path))
    on_cpu, _ = load_exported(str(tmp_path), device="cpu")
    assert on_card.model.device.type == "cuda"
    reset_launch_counts()
    got = on_card(small, moved)
    # the request replays its bucket's program: its launches were counted at the capture
    assert launch_counts() == {"radius_knn": 0, "sinkhorn": 0}
    program = on_card.programs[512].launches
    assert {k: program[k] for k in ("radius_knn", "sinkhorn")} == {"radius_knn": 12,
                                                                   "sinkhorn": 1}
    want = on_cpu(small, moved)
    assert on_card.last_cap == on_cpu.last_cap == 512
    valid = want["corr_scores"] > 0
    assert torch.equal(torch.from_numpy(got["corr_scores"] > 0), torch.from_numpy(valid))
    for k in ("ref_corr_points", "src_corr_points"):
        np.testing.assert_array_equal(got[k][valid], want[k][valid])
    np.testing.assert_allclose(got["corr_scores"], want["corr_scores"], atol=1e-3)
    np.testing.assert_allclose(want["estimated_transform"], motion, atol=0.05)
    np.testing.assert_allclose(got["estimated_transform"], want["estimated_transform"], atol=1e-4)


def test_ransac_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(12)
    n, n_in = 2048, 800
    angle = 0.3
    tf = np.eye(4, dtype=np.float32)
    tf[:2, :2] = [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
    tf[:3, 3] = [1.0, -2.0, 0.5]
    src = ((rng.rand(n, 3) - 0.5) * 40).astype(np.float32)
    ref = (src @ tf[:3, :3].T + tf[:3, 3] + (rng.rand(n, 3) - 0.5) * 0.02).astype(np.float32)
    ref[n_in:] = (rng.rand(n - n_in, 3) - 0.5) * 40
    mask = torch.ones(n, dtype=torch.bool)
    u = torch.rand(4, 1024, 4, generator=torch.Generator().manual_seed(0))
    args = [torch.from_numpy(src), torch.from_numpy(ref), mask, u]
    kw = dict(num_iterations=4096, chunk=1024, threshold=0.3)
    with torch.no_grad():
        want = ransac_registration(*args, **kw)
        got = ransac_registration(*[a.to(cuda) for a in args], **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(want.numpy(), tf, atol=1e-2)
    host = ransac_registration_host(src, ref, num_iterations=5000)
    np.testing.assert_allclose(host, tf, atol=1e-2)


def _tiny_root(path):
    write_procedural_root(str(path), "kitti", {0: (11, 3), 6: (12, 2), 8: (13, 3)},
                          n_rings=16, n_azimuths=200)
    return str(path)


def _loaders(root):
    train = RegistrationPairDataset("kitti", root, "train", point_limit=500)
    val = RegistrationPairDataset("kitti", root, "val", point_limit=500)
    return (PairLoader(train, cap=512, shuffle=True, drop_last=True),
            PairLoader(val, cap=512))


def _host_states_equal(a, b):
    for part in ("model", "accumulator"):
        assert (a[part] is None) == (b[part] is None)
        for k, v in (a[part] or {}).items():
            assert torch.equal(v, b[part][k]), (part, k)
    for name, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v.cpu(), b["optimizer"]["state"][name][k].cpu()), (name, k)
    assert [a[k] for k in ("count", "mini_step", "notfinite_count")] == \
        [b[k] for k in ("count", "mini_step", "notfinite_count")]


def test_trainer_epoch_on_card_and_checkpoint_across_devices(cuda, tmp_path):
    root = _tiny_root(tmp_path / "root")
    cfg = make_tiny_cfg()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, max_epoch=1,
                                                             grad_acc_steps=1))
    trainer = Trainer(cfg, *_loaders(root), output_dir=str(tmp_path / "run"), log_steps=1,
                      device=cuda)
    reset_launch_counts()
    trainer.run()
    steps, pairs = trainer.epoch_timings[0]["steps"], trainer.val_timings[0]["pairs"]
    assert (steps, pairs) == (2, 1)
    assert launch_counts() == {"radius_knn": 12 * (steps + 1), "sinkhorn": 1}
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        assert all(np.isfinite(v) for line in f for v in json.loads(line).values()
                   if isinstance(v, float))
    assert trainer.snapshots.all_steps() == [1] and trainer.state.count == 2

    # card -> CPU -> card, through the files
    on_card = state_to_host(trainer.state)
    cpu_state = create_train_state(cfg, RDMNet(cfg, device="cpu"))
    CheckpointManager(str(tmp_path / "run" / "snapshots")).restore(cpu_state)
    assert cpu_state.device.type == "cpu"
    _host_states_equal(on_card, state_to_host(cpu_state))
    mgr = CheckpointManager(str(tmp_path / "from_cpu"))
    mgr.save(1, cpu_state)
    card_state = create_train_state(cfg, RDMNet(cfg, device=cuda,
                                                generator=torch.Generator().manual_seed(9)))
    mgr.restore(card_state)
    assert card_state.device.type == "cuda"
    _host_states_equal(on_card, state_to_host(card_state))


def test_eval_loop_on_card_matches_cpu(cuda, tmp_path):
    root = _tiny_root(tmp_path / "root")
    cfg = make_tiny_cfg()
    cfgs = [dataclasses.replace(cfg, pyramid=cfg.pyramid.scaled(s)) for s in (0.5, 1.0)]
    dirs = [str(tmp_path / "card"), str(tmp_path / "cpu")]
    for dev, out in zip((cuda, torch.device("cpu")), dirs):
        model = RDMNet(cfgs[-1], device=dev, generator=torch.Generator().manual_seed(1))
        dataset = RegistrationPairDataset("kitti", root, "test", point_limit=400)
        os.makedirs(out)
        reset_launch_counts()
        board = run_eval_loop(cfgs[-1], model, dataset, list(range(len(dataset))), out,
                              cfgs=cfgs, device=dev, log=lambda line: None)
        if dev.type == "cuda":
            assert launch_counts() == {"radius_knn": 12 * len(dataset), "sinkhorn": len(dataset)}
        assert all(np.isfinite(v) for v in board.summary().values())
    names = sorted(os.listdir(dirs[1]))
    assert names == sorted(os.listdir(dirs[0])) and len(names) == 2
    for name in names:
        got, want = np.load(os.path.join(dirs[0], name)), np.load(os.path.join(dirs[1], name))
        assert set(got.files) == set(want.files)
        for key in ("ref_points", "src_points", "ref_points_f", "src_points_f",
                    "ref_node_corr_indices", "src_node_corr_indices", "gt_node_corr_indices",
                    "transform"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        np.testing.assert_allclose(got["ref_feats_c"], want["ref_feats_c"], atol=1e-3)


# ------------------------------------------------- bfloat16 and data preparation

def _rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm())


def test_bf16_pipeline_on_card_matches_cpu(cuda):
    """bfloat16 on the card against bfloat16 on the CPU, with the bound of
    ``test_torch_port_bf16.py``: no further apart than twice the CPU's
    bfloat16 distance from its float32."""
    cfg = make_tiny_cfg()
    ref, src, _ = procedural_pair(3, n_rings=16, n_azimuths=200)
    ref, src = ref[:500], src[:500]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        for dt in ("float32", "bfloat16"):
            model = RDMNet(dataclasses.replace(cfg, compute_dtype=dt), device=dev,
                           generator=torch.Generator().manual_seed(1))
            reset_launch_counts()
            outs[dev.type, dt] = pipeline(model, *pad_cloud(ref, 512, device=dev),
                                          *pad_cloud(src, 512, device=dev), device=dev)
            if dev.type == "cuda":
                assert launch_counts() == {"radius_knn": 12, "sinkhorn": 1}
            assert {p.dtype for p in model.parameters()} == {torch.float32}
    card, cpu = outs["cuda", "bfloat16"], outs["cpu", "bfloat16"]
    for side in ("ref", "src"):
        for field in ("points", "neighbors", "subsampling", "upsampling"):
            for a, b in zip(getattr(getattr(card["batch"], side), field),
                            getattr(getattr(cpu["batch"], side), field)):
                assert torch.equal(a.cpu(), b)
    v = cpu["nodes_ref_valid"] & outs["cpu", "float32"]["nodes_ref_valid"]
    for key in ("ref_feats_c", "ref_feats_f", "ref_n2p_scores_c"):
        sel = v if key == "ref_feats_c" else slice(None)
        assert card[key].dtype == torch.float32 and torch.isfinite(card[key]).all()
        yard = _rel(cpu[key][sel], outs["cpu", "float32"][key][sel])
        assert _rel(card[key][sel].cpu(), cpu[key][sel]) <= 2 * yard, key
    assert torch.isfinite(card["estimated_transform"]).all()


def test_bf16_gemm_on_card_matches_widened_products(cuda):
    from rdmnet_tpu_torch.nn.precision import matmul_f32

    rng = np.random.RandomState(2)
    for sa, sb in (((300, 960), (960, 64)), ((64, 15, 40), (64, 40, 32))):
        a = torch.from_numpy(rng.randn(*sa).astype(np.float32)).to(torch.bfloat16)
        b = torch.from_numpy(rng.randn(*sb).astype(np.float32)).to(torch.bfloat16)
        g = torch.from_numpy(rng.randn(*(sa[:-1] + sb[-1:])).astype(np.float32))
        out = {}
        for dev in (cuda, torch.device("cpu")):
            x, y = a.to(dev).requires_grad_(), b.to(dev).requires_grad_()
            c = matmul_f32(x, y)
            c.backward(g.to(dev))
            out[dev.type] = (c.detach().cpu(), x.grad.cpu(), y.grad.cpu())
            assert c.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
        # products are exact in float32: only the summation order differs
        torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-4)
        for gc, gh in zip(out["cuda"][1:], out["cpu"][1:]):
            torch.testing.assert_close(gc.float(), gh.float(), rtol=1e-2, atol=1e-2)


def test_bf16_train_step_on_card(cuda):
    cfg = dataclasses.replace(make_tiny_cfg(), compute_dtype="bfloat16")
    model = RDMNet(cfg, device=cuda, generator=torch.Generator().manual_seed(1))
    state = create_train_state(cfg, model, steps_per_epoch=10)
    reset_launch_counts()
    batch = _train_pair(cfg, cuda)  # the graph build: the step's 12 searches
    metrics, grads = make_value_and_grad(cfg, device=cuda)(
        state, batch, torch.Generator(device=cuda).manual_seed(1))
    assert launch_counts() == {"radius_knn": 12, "sinkhorn": 0}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    assert state.apply_gradients(grads)
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_icp_search_on_card_matches_plain_and_native(cuda):
    """ICP's search on the card: one kernel launch whose table equals the
    plain version's, re-ranked so that no row picks a farther point than the
    native library (``test_torch_port_preprocess.py`` shows why the kernel's
    own nearest is not enough far from the origin)."""
    from rdmnet_tpu_torch.data.preprocess import ICP_CANDIDATES, candidate_radius, nearest_within
    from rdmnet_tpu_torch.graph.native import radius_knn_native

    scan = procedural_sequence(5, 1, n_rings=64, n_azimuths=1800)[0][0][:, :3]
    moved = scan + np.random.RandomState(0).randn(*scan.shape) * 0.05
    extent = float(np.linalg.norm(moved, axis=1).max())
    ref, n = torch.from_numpy(scan).to(cuda), len(scan)
    reset_launch_counts()
    got = nearest_within(torch.from_numpy(moved).to(cuda), ref, 0.5, extent).cpu().numpy()
    assert launch_counts()["radius_knn"] == 1
    q = torch.from_numpy(moved.astype(np.float32))
    wide = candidate_radius(0.5, extent)
    table = radius_knn_cuda(q[None].to(cuda), ref[None], torch.tensor([n], dtype=torch.int32,
                                                                      device=cuda),
                            wide, ICP_CANDIDATES)
    want = radius_knn_plain(q[None, :4096], torch.from_numpy(scan)[None], torch.tensor([n]),
                            wide, ICP_CANDIDATES)
    assert torch.equal(table[:, :4096].cpu(), want)
    native = radius_knn_native(q.numpy(), scan, n, 0.5, 1)[:, 0]
    d2 = lambda idx: ((q.numpy().astype(np.float64)  # noqa: E731
                       - scan.astype(np.float64)[np.minimum(idx, n - 1)]) ** 2).sum(1)
    both = (got < n) & (native < n)
    assert not (both & (d2(got) > d2(native) * (1 + 1e-6))).any()
    assert (got != native).sum() <= 1e-3 * n


def test_icp_and_calibration_on_card_match_cpu(cuda, monkeypatch):
    """ICP: each iteration's pairing on the card against the CPU's (the same
    pair count; cross-covariance within 1e-6 of its size, the source
    centroid 1e-9, the reference centroid 1e-5: the CPU takes the JAX
    package's float32 mean of the reference points, measured 1.9e-6 from
    the card's float64 one), one kNN launch per iteration, and the final
    transforms within 1e-3 (over tens of iterations on a sparse pair 10 m
    apart the two means move the optimum by ~1e-4; phase 13 of
    ``chip_smoke.py`` holds the ground truth of its pairs to 1e-4).
    Calibration: equal limits, band caps and neighbour counts."""
    from rdmnet_tpu_torch.config import PyramidConfig
    from rdmnet_tpu_torch.data import calibration
    from rdmnet_tpu_torch.data import preprocess

    scans, poses = procedural_sequence(5, 2, n_rings=32, n_azimuths=900)
    src, ref = scans[0][:, :3], scans[1][:, :3]
    init = np.linalg.inv(poses[1]) @ poses[0]
    extent = (float(np.linalg.norm(src, axis=1).max()), float(np.linalg.norm(ref, axis=1).max()))
    clouds = (torch.from_numpy(src).double().to(cuda), torch.from_numpy(ref).to(cuda))
    tf = init
    for _ in range(3):
        n_c, h_c, a_c, b_c = preprocess._pair_stats_card(*clouds, tf, 0.5, extent)
        n_h, h_h, a_h, b_h = preprocess._pair_stats_host(src, ref, tf, 0.5)
        assert n_c == n_h > 10
        for x, y, tol in ((h_c, h_h, 1e-6), (a_c, a_h, 1e-9), (b_c, b_h, 1e-5)):
            np.testing.assert_allclose(x, y, rtol=0, atol=tol * np.abs(y).max())
        tf = np.eye(4)
        tf[:3, 3] = b_h - a_h
        tf = tf @ init  # move on by the centroid shift: another pairing
    calls = []
    search = preprocess.nearest_within
    monkeypatch.setattr(preprocess, "nearest_within",
                        lambda *a: calls.append(1) or search(*a))
    reset_launch_counts()
    on_card = preprocess.icp_point_to_point(src, ref, init=init, device=cuda)
    assert launch_counts()["radius_knn"] == len(calls) >= 2
    on_cpu = preprocess.icp_point_to_point(src, ref, init=init, device="cpu")
    np.testing.assert_allclose(on_card, on_cpu, atol=1e-3)

    spec = PyramidConfig(caps=(4096, 2048, 1024, 512, 256), neighbor_limits=(40,) * 5)
    clouds = [s[:, :3] for s in scans]
    for fn in (calibration.calibrate_neighbor_limits, calibration.calibrate_band_caps):
        assert fn(clouds, spec, device=cuda) == fn(clouds, spec, device="cpu")
    pts = torch.from_numpy(clouds[0])
    np.testing.assert_array_equal(
        calibration._neighbor_counts(pts.to(cuda), len(pts), 0.75),
        calibration._neighbor_counts(pts, len(pts), 0.75))


def test_kernels_launch_on_the_tensors_card(cuda):
    """With card 0 current, both kernels on tensors of card 1 launch there
    and equal their plain versions (the wrappers hand the launch the tensors'
    stream and make their card current for it)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    q = torch.from_numpy(_lidar_like(3, 4096)).to(other)[None]
    count = torch.tensor([4000], dtype=torch.int32, device=other)
    before = radius_knn_cuda.launches
    got = radius_knn_cuda(q, q, count, 1.275, 40)
    assert got.device == other and radius_knn_cuda.launches == before + 1
    torch.cuda.synchronize(other)
    assert torch.equal(got, radius_knn_plain(q, q, count, 1.275, 40))
    rng = np.random.RandomState(4)
    args = [torch.from_numpy(x).to(other) for x in (
        (rng.randn(16, 129, 129) * 3).astype(np.float32),
        (rng.randn(16, 129) * 0.1).astype(np.float32),
        (rng.randn(16, 129) * 0.1).astype(np.float32))]
    out = sinkhorn_cuda(*args, 100)
    torch.cuda.synchronize(other)
    assert out.device == other and torch.cuda.current_device() == 0
    torch.testing.assert_close(out, sinkhorn_plain(*args, 100), rtol=1e-4, atol=1e-4)


def test_fast_contracts_on_card(cuda):
    """The contracts launch both kernels on the card (one kNN, one Sinkhorn
    launch) and all three pass."""
    from rdmnet_tpu_torch.utils.contracts import run_fast_contracts

    before = launch_counts()
    assert run_fast_contracts() == {"knn_exact": "pass", "sinkhorn": "pass",
                                    "horn_pose_recovery": "pass"}
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"radius_knn": 1, "sinkhorn": 1}


@pytest.mark.parametrize("k", [8, 256, 257])
def test_group_and_aggregate_on_card_matches_plain(cuda, k):
    from rdmnet_tpu_torch.nn.point_matching import group_and_aggregate

    rng = np.random.RandomState(12)
    s = _lidar_like(5, 6000)
    q = torch.from_numpy(s[rng.permutation(len(s))[:1500]])
    feats = torch.from_numpy(rng.randn(len(s), 32).astype(np.float32))
    count = torch.tensor(5800, dtype=torch.int32)
    want = group_and_aggregate(q, torch.from_numpy(s), feats, count, 2.4, k)
    before = radius_knn_cuda.launches
    got = group_and_aggregate(q.to(cuda), torch.from_numpy(s).to(cuda), feats.to(cuda),
                              count.to(cuda), 2.4, k)
    assert radius_knn_cuda.launches == before + 1
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])  # a max of the same rows: exact


def test_overfit_demo_learns_on_card(cuda):
    """``chip_smoke.py`` phase 17 (a): the overfit demo at ``make_cfg()`` width
    for 150 steps, the batch built once: every metric finite, the mean loss of
    steps 141-150 below that of steps 1-10, 12 kNN launches for the build,
    none in a train step, one Sinkhorn launch and no kNN per eval step."""
    from rdmnet_tpu_torch.tools import overfit_demo

    cfg = overfit_demo.demo_cfg()
    ref, src, tf_gt = overfit_demo.demo_pair(overfit_demo.demo_scan())
    demo = overfit_demo.run(cfg, ref, src, tf_gt, steps=150, log_every=50, device=cuda,
                            verbose=False)
    assert [r["step"] for r in demo.rows] == [1, 50, 100, 150]
    assert all(np.isfinite(v) for r in demo.rows + [demo.final] for v in r.values())
    assert all(np.isfinite(demo.losses))
    assert np.mean(demo.losses[-10:]) < np.mean(demo.losses[:10])
    assert demo.launches == {"build": {"radius_knn": 12, "sinkhorn": 0},
                             "train": {"radius_knn": 0, "sinkhorn": 0},
                             "eval": {"radius_knn": 0, "sinkhorn": demo.n_evals}}


# ---- the serving program: host-sync-free ops, the captured pipeline --------------------------

def _program_launches(cfg):
    """Launches of one pair's pipeline by kernel, counted at its capture."""
    return {"radius_knn": 12, "sinkhorn": 1, "segment_sums": cfg.pyramid.num_stages - 1,
            "nms_peel": 1, "eigh4": 2 + cfg.fine_matching.num_refinement_steps}


def test_segment_sums_kernel_bit_equal_to_plain(cuda):
    """Random segments (one of 3000 rows) and the grid subsample of a
    procedural scan through every level: the kernel's sums and the op's
    centroids equal the plain version's bit for bit."""
    from rdmnet_tpu_torch.ops.grid_subsample import grid_subsample
    from rdmnet_tpu_torch.ops.kernels.segment_sum import segment_sums_cuda, segment_sums_plain

    rng = np.random.RandomState(5)
    lengths = np.concatenate([[3000], rng.randint(0, 40, size=999)])
    n = int(lengths.sum())
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pts = torch.from_numpy((rng.randn(2, n, 3) * 30).astype(np.float32)).to(cuda)
    start = torch.from_numpy(np.stack([starts, starts]).astype(np.int32)).to(cuda)
    length = torch.from_numpy(np.stack([lengths, lengths[::-1].copy()]).astype(np.int32))
    start[1] = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths[::-1])[:-1]])
                                .astype(np.int32)).to(cuda)
    length = length.to(cuda)
    before = segment_sums_cuda.launches
    got = segment_sums_cuda(pts, start, length)
    torch.cuda.synchronize()
    assert segment_sums_cuda.launches == before + 1
    assert torch.equal(got, segment_sums_plain(pts, start, length))
    ref, _, _ = procedural_pair(3, n_rings=32, n_azimuths=800)
    cpu_pts, _ = pad_cloud(ref, 16384)
    count = torch.tensor([min(len(ref), 16384)], dtype=torch.int32)
    card_pts, card_count = cpu_pts[None].to(cuda), count.to(cuda)
    cpu_pts = cpu_pts[None]
    voxel = 0.3
    for cap in (8192, 4096, 2048, 1024):
        voxel *= 2.0
        card_pts, card_count, card_drop = grid_subsample(card_pts, card_count, voxel, cap)
        cpu_pts, count, drop = grid_subsample(cpu_pts, count, voxel, cap)
        assert torch.equal(card_pts.cpu(), cpu_pts) and torch.equal(card_count.cpu(), count)
        assert torch.equal(card_drop.cpu(), drop)


@pytest.mark.parametrize("case, m", [("random", 640), ("limit", 640), ("chain", 512),
                                     ("random", 1600), ("chain", 1600)])
def test_nms_peel_kernel_equals_plain(cuda, case, m):
    """Keep masks and rounds of the kernel equal the plain version's on the
    same adjacency, and the CPU's: m random nodes a cloud (with masked
    ones), the parity config's truncated adjacency, and a chain (256 rounds
    at 512 nodes, over 600 at 1600). At M = 1600 the packed rows pass a
    CTA's shared memory and the kernel holds them in device memory."""
    from rdmnet_tpu_torch.ops.kernels.nms import nms_peel_cuda, nms_peel_plain
    from rdmnet_tpu_torch.ops.nms import greedy_nms

    rng = np.random.RandomState(8)
    radius, limit = 2.4, None
    if case == "chain":
        nodes = np.zeros((2, m, 3), np.float32)
        nodes[:, :, 0] = np.arange(m) * 0.9 * radius
        mask = np.ones((2, m), bool)
    else:
        side = 80 * np.sqrt(m / 640)  # the node density of 640 nodes in 80 m x 80 m
        nodes = (rng.rand(2, m, 3) * np.float32([side, side, 6])).astype(np.float32)
        mask = rng.rand(2, m) > 0.1
        if case == "limit":
            radius, limit = 6.0, 5
    path = "shared" if m <= 1348 else "device"
    before = nms_peel_cuda.path_launches[path]
    keep, rounds = greedy_nms(torch.from_numpy(nodes).to(cuda), torch.from_numpy(mask).to(cuda),
                              radius, neighbor_limit=limit)
    assert nms_peel_cuda.path_launches[path] == before + 1
    want_keep, want_rounds = greedy_nms(torch.from_numpy(nodes), torch.from_numpy(mask), radius,
                                        neighbor_limit=limit)
    assert torch.equal(keep.cpu(), want_keep) and int(rounds) == int(want_rounds)
    if case == "chain":
        # at 1600 nodes the chain's far end lies ~3.5 km out, where float32's squared
        # distances drop some links: 673 rounds, not 800, on the CPU as on the card
        assert int(rounds) == m // 2 if m == 512 else int(rounds) >= 600
    adj = torch.from_numpy(np.tril(rng.rand(2, m, m) > 0.97, -1)).to(cuda)
    live = torch.from_numpy(rng.rand(2, m) > 0.2).to(cuda)
    got, got_rounds = nms_peel_cuda(adj, live)
    plain, plain_rounds = nms_peel_plain(adj, live)
    assert torch.equal(got, plain) and int(got_rounds) == int(plain_rounds)
    # rows whose length is no multiple of 16 take the kernel's byte loads
    odd = adj[:, : m - 7, : m - 7].contiguous()
    got, got_rounds = nms_peel_cuda(odd, live[:, : m - 7].contiguous())
    plain, plain_rounds = nms_peel_plain(odd, live[:, : m - 7])
    assert torch.equal(got, plain) and int(got_rounds) == int(plain_rounds)


def _rotation_of(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def test_eigh4_kernel_rotation_matches_eigh(cuda):
    """10^4 seeded fits (40 noisy correspondences under a random pose, random
    weights): the kernel's rotation within 1e-5 of ``torch.linalg.eigh``'s
    where the top eigenvalue stands 1e-2 of the norm clear of the next
    (every fit here); a zero H gives the identity quaternion."""
    from rdmnet_tpu_torch.ops.kernels.eigh4 import eigh4_cuda, top_eigenvector_plain
    from rdmnet_tpu_torch.ops.procrustes import cross_covariance, horn_matrix

    rng = np.random.RandomState(6)
    n = 10_000
    q = rng.randn(n, 4)
    rot = _rotation_of(torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)))
    src = torch.from_numpy(rng.randn(n, 40, 3) * 10)
    ref = src @ rot.transpose(1, 2) + torch.from_numpy(rng.randn(n, 1, 3) * 3 + rng.randn(n, 40, 3)
                                                       * 0.05)
    w = torch.from_numpy(rng.rand(n, 40))
    h, _, _ = cross_covariance(src.float().to(cuda), ref.float().to(cuda), w.float().to(cuda))
    k = horn_matrix(h).contiguous()
    got = _rotation_of(eigh4_cuda(k))
    want = _rotation_of(top_eigenvector_plain(k))
    vals = torch.linalg.eigvalsh(k.double())
    gap = (vals[:, -1] - vals[:, -2]) / vals.abs().amax(dim=1)
    assert bool((gap > 1e-2).all())
    assert float((got - want).abs().amax()) <= 1e-5
    zero = eigh4_cuda(torch.zeros((3, 4, 4), device=cuda))
    assert torch.equal(zero.abs().cpu(), torch.tensor([[1.0, 0, 0, 0]] * 3))


def test_pipeline_has_no_host_sync(cuda):
    """``pipeline`` on inputs already on the card waits for the host nowhere:
    under ``set_sync_debug_mode("error")`` a synchronising op raises."""
    cfg = make_tiny_cfg()
    ref, src, _ = procedural_pair(3, n_rings=16, n_azimuths=200)
    model = RDMNet(cfg, device=cuda, generator=torch.Generator().manual_seed(1))
    args = (*pad_cloud(ref[:500], 512, device=cuda), *pad_cloud(src[:500], 512, device=cuda))
    pipeline(model, *args, device=cuda)  # kernels built, handles made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipeline(model, *args, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out["estimated_transform"]).all()


def _serving_pairs():
    """Requests that rise, then fall in size, and one past the capacity."""
    ref, src, _ = procedural_pair(7353, n_rings=16, n_azimuths=300)
    rng = np.random.RandomState(0)
    ref, src = ref[rng.permutation(len(ref))], src[rng.permutation(len(src))]
    return [(ref[:n], src[:n - 9]) for n in (220, 480, 250, len(ref))]


def _same_result(got, want, where):
    for k in ("ref_node_corr_indices", "src_node_corr_indices", "node_corr_valid",
              "nodes_ref_valid", "nodes_src_valid", "nms_rounds", "dropped"):
        assert torch.equal(got[k].cpu(), want[k].cpu()), (where, k)
    for side in ("ref", "src"):
        for field in ("points", "neighbors", "subsampling", "upsampling"):
            for a, b in zip(getattr(getattr(got["batch"], side), field),
                            getattr(getattr(want["batch"], side), field)):
                assert torch.equal(a.cpu(), b.cpu()), (where, side, field)
    for k in ("estimated_transform", "corr_scores"):
        assert float((got[k] - want[k]).abs().max()) <= 1e-5, (where, k)


def test_captured_pipeline_replays_eager(cuda):
    """Each bucket's program against the eager ``pipeline`` over requests
    that rise and fall in size: tables, NMS keep masks and rounds and
    matched node pairs equal, poses and scores within 1e-5."""
    from rdmnet_tpu_torch.models import capture_pipeline, with_pyramid
    from rdmnet_tpu_torch.serving import _pad_np

    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device=cuda, generator=torch.Generator().manual_seed(1))
    pool = torch.cuda.graph_pool_handle()
    for scale in (0.5, 1.0):
        pyr = cfg.pyramid if scale == 1.0 else cfg.pyramid.scaled(scale)
        view = with_pyramid(model, pyr)
        program = capture_pipeline(view, cuda, pool=pool)
        assert program.launches == _program_launches(cfg)
        cap = pyr.caps[0]
        for i, (r, s) in enumerate(_serving_pairs()):
            rp, rc = _pad_np(r, cap)
            sp, sc = _pad_np(s, cap)
            got = program(r[:cap], rc, s[:cap], sc)
            want = pipeline(view, rp, rc, sp, sc, device=cuda)
            torch.cuda.synchronize()
            _same_result(got, want, (scale, i))


def test_served_replays_over_http_threads_match_eager(cuda, tmp_path):
    """Eight clients send four requests each at once over HTTP to a server
    whose buckets replay captured programs: every answer equals the eager
    pipeline's on the same model and bucket."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from rdmnet_tpu_torch.cli.serve import make_handler
    from rdmnet_tpu_torch.models import with_pyramid
    from rdmnet_tpu_torch.serving import SERVE_OUTPUTS, _pad_np, bucket_configs

    cfg = make_tiny_cfg()
    export_inference(cfg, RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1)),
                     str(tmp_path), bucket_scales=(0.5, 1.0))
    serve, meta = load_exported(str(tmp_path))
    assert sorted(serve.programs) == [256, 512]
    views = {b["cap"]: with_pyramid(serve.model, b["cfg"].pyramid)
             for b in bucket_configs(cfg, (0.5, 1.0))}
    pairs = _serving_pairs()
    want = []
    for r, s in pairs:
        cap = 256 if max(len(r), len(s)) <= 256 else 512
        out = pipeline(views[cap], *_pad_np(r, cap), *_pad_np(s, cap), device=cuda)
        want.append({k: out[k].cpu().numpy() for k in SERVE_OUTPUTS})
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(serve, meta))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/register"
    answers, errors = {}, []

    def client(c):
        try:
            for j in range(4):
                i = (c + j) % len(pairs)
                buf = io.BytesIO()
                np.savez(buf, ref_points=pairs[i][0], src_points=pairs[i][1])
                req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    answers[(c, j)] = (i, dict(np.load(io.BytesIO(resp.read()))))
        except Exception as e:  # reported below
            errors.append(e)

    try:
        clients = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not errors and len(answers) == 32
    for i, got in answers.values():
        sel = want[i]["corr_scores"] > 0
        assert len(got["corr_scores"]) == int(sel.sum())
        np.testing.assert_array_equal(got["ref_corr_points"], want[i]["ref_corr_points"][sel])
        np.testing.assert_allclose(got["estimated_transform"], want[i]["estimated_transform"],
                                   rtol=0, atol=1e-5)


# ------------------------------------------------------- the Trainer's programs

def _train_pairs(n, nan_at=None):
    """``n`` one-pair host batches of the tiny config (a procedural pair, src
    moved by seeded rigid motions); the one at ``nan_at`` has a NaN in its
    ground truth."""
    ref, src, gt = procedural_pair(7354, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(1)
    ref, src = ref[rng.permutation(len(ref))[:500]], src[rng.permutation(len(src))[:480]]
    out = []
    for i in range(n):
        a = rng.uniform(-0.2, 0.2)
        m = np.eye(4)
        m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        m[:3, 3] = rng.uniform(-1, 1, 3)
        (rp, rc), (sp, sc) = pad_cloud(ref, 512), pad_cloud(src @ m[:3, :3].T.astype(np.float32)
                                                             + m[:3, 3].astype(np.float32), 512)
        tf = (gt @ np.linalg.inv(m)).astype(np.float32)
        if i == nan_at:
            tf[0, 3] = np.nan
        out.append({"ref_points": rp.numpy()[None], "ref_counts": rc.numpy()[None],
                    "src_points": sp.numpy()[None], "src_counts": sc.numpy()[None],
                    "transform": tf[None]})
    return out


def _bits(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _written(state):
    """Every tensor a train step writes, as bytes."""
    opt = [state.optimizer.state[p] for p in state.params if p in state.optimizer.state]
    tensors = (list(state.params) + [s[k] for s in opt for k in ("exp_avg", "exp_avg_sq", "step")]
               + list(state.counters.values()) + [state.lr] + (state.accumulator or []))
    return torch.cat([_bits(t) for t in tensors])


@pytest.mark.parametrize("grad_acc", [1, 2])
def test_train_program_replays_equal_eager(cuda, grad_acc):
    """The captured train step (2 eager warm-ups, the capture, replays)
    against the eager step from the same weights, generator and batches,
    one with a NaN ground truth: metrics and every tensor the step writes
    bit-equal after every step, the generators at one offset, the NaN
    update skipped; launches counted at the capture."""
    from rdmnet_tpu_torch.engine import capture_train_step, make_train_step

    cfg = make_tiny_cfg()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=grad_acc))
    states = [create_train_state(cfg, RDMNet(cfg, device=cuda,
                                             generator=torch.Generator().manual_seed(3)))
              for _ in range(2)]
    gens = [torch.Generator(device=cuda).manual_seed(5) for _ in range(2)]
    program = capture_train_step(states[0], cfg, 1, gens[0], cuda)
    step = make_train_step(cfg, cuda)
    for i, host in enumerate(_train_pairs(6, nan_at=3)):
        got = program(host)
        _, want = step(states[1], batch_to_device(host, cfg.pyramid, cuda), gens[1])
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), (i, k)
        assert torch.equal(_written(states[0]), _written(states[1])), i
        assert torch.equal(gens[0].get_state(), gens[1].get_state()), i
    assert program.graph is not None and program.launches["radius_knn"] == 12
    assert program.launches["sinkhorn"] == 0
    assert states[0].count == (5 if grad_acc == 1 else 2) and states[0].notfinite_count == 0


def test_eval_program_replays_equal_eager(cuda):
    """The captured eval step on two pairs a batch, ``valid`` weighting
    included: metrics and transforms bit-equal to the eager step's."""
    from rdmnet_tpu_torch.engine import capture_eval_step, make_eval_step

    cfg = make_tiny_cfg()
    state = create_train_state(cfg, RDMNet(cfg, device=cuda,
                                           generator=torch.Generator().manual_seed(3)))
    program = capture_eval_step(state, cfg, 2, cuda)
    evaluate = make_eval_step(cfg, cuda)
    pairs = _train_pairs(4)
    for i, valid in enumerate([(True, True), (True, False), (False, True), (True, True)]):
        host = {k: np.concatenate([pairs[i][k], pairs[(i + 1) % 4][k]]) for k in pairs[0]}
        got, got_tf = program(host, np.array(valid))
        want, want_tf = evaluate(state, batch_to_device(host, cfg.pyramid, cuda),
                                 torch.tensor(valid))
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), (i, k)
        assert torch.equal(got_tf, want_tf), i
    assert program.launches == {k: 2 * v for k, v in _program_launches(cfg).items()}


def test_trainer_on_programs_equals_an_eager_trainer(cuda, tmp_path):
    """Two epochs of the Trainer on its captured programs and of a Trainer
    kept eager: equal ``metrics.jsonl`` records and final states."""
    root = _tiny_root(tmp_path / "root")
    cfg = make_tiny_cfg()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, max_epoch=3))
    records, states = [], []
    for programs in (True, False):
        out = tmp_path / f"run{programs}"
        trainer = Trainer(cfg, *_loaders(root), output_dir=str(out), log_steps=1, device=cuda)
        trainer.use_programs = programs
        trainer.run()
        assert (trainer.train_program is not None) == programs
        with open(out / "metrics.jsonl") as f:
            records.append([json.loads(line) for line in f])
        states.append(state_to_host(trainer.state))
    assert records[0] == records[1]
    _host_states_equal(*states)
