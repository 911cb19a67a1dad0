"""CUDA kernels of the port against their plain PyTorch versions, and the
training, serving and evaluation paths against the CPU's, on the card; the
model's construction-time check of the kernels' limits (k <= 256,
num_points_in_patch + 1 <= 208).

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
from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rdmnet_tpu_torch.ops.kernels.radius_knn import (WINDOW_ROWS_MAX, knn_plan, radius_knn_cuda,
                                                     radius_knn_plain)
from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda, sinkhorn_plain
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


@pytest.mark.parametrize("k1", [17, 65, 129, 200])
def test_sinkhorn_kernel_masks_at_every_size(cuda, k1):
    """Masked rows, masked columns, both, and a fully masked patch at every
    register layout of the kernel (K1 <= 32, 80, 144, 208)."""
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
    got = sinkhorn_cuda(*args, 100)
    torch.cuda.synchronize()
    want = sinkhorn_plain(*args, 100)
    live = want > -1e11
    assert torch.isfinite(got).all()
    assert torch.equal(got > -1e11, live)
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 16, 40, 64, 128, 81, 200, 256])
def test_radius_knn_kernel_exact_ties_in_tiled_window(cuda, k):
    """Duplicated support points in an unbanded window too large for one
    tile; s_count ends inside the last tile of cloud 0."""
    n = 2 * WINDOW_ROWS_MAX + 1000
    s = torch.from_numpy(np.stack([_duplicated(20, n), _duplicated(21, n)])).to(cuda)
    q = s[:, ::7].contiguous()
    cnt = torch.tensor([n - 333, n], dtype=torch.int32, device=cuda)
    assert knn_plan(2, q.shape[1], n, k).tiled
    got = radius_knn_cuda(q, s, cnt, 1.275, k)
    torch.cuda.synchronize()
    want = radius_knn_plain(q, s, cnt, 1.275, k)
    assert torch.equal(got, want)
    assert (want[..., :2] < n).all(dim=-1).float().mean() > 0.9  # most rows have a tie pair


@pytest.mark.parametrize("k", [1, 16, 40, 64, 128, 81, 200, 256])
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


@pytest.mark.parametrize("k", [81, 200, 256])
@pytest.mark.parametrize("level", [0, 4])
def test_radius_knn_kernel_large_k_at_main_path_shapes(cuda, k, level):
    """The 128- and 256-entry lists at the 0.7 bucket's level-0 (banded,
    21504 rows) and level-4 (512 rows) neighbour searches of a ~20k-point
    procedural scan pair."""
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, search_plan

    pyr = make_cfg().pyramid.scaled(0.7)
    pyr = dataclasses.replace(pyr, neighbor_limits=(k,) * 5)
    ref, src, _ = procedural_pair(7351, n_rings=80, n_azimuths=3000)
    cap = pyr.caps[0]
    batch = build_pair_batch(*pad_cloud(ref, cap, device=cuda), *pad_cloud(src, cap, device=cuda),
                             torch.eye(4, device=cuda), pyr)
    sp = next(p for p in search_plan(pyr) if p.table == "neighbors" and p.q_lvl == level)
    pts = torch.stack([batch.ref.points[level], batch.src.points[level]]).contiguous()
    cnt = torch.stack([batch.ref.counts[level], batch.src.counts[level]]).to(torch.int32)
    kw = {}
    if sp.band is not None:
        win, _ = band_windows(pts, pts, cnt, sp.radius, sp.cell, sp.band, sp.chunk)
        kw = dict(win=win, chunk=sp.chunk, band=sp.band)
    assert knn_plan(2, pts.shape[1], pts.shape[1], k, sp.band).k_bucket == (128 if k <= 128
                                                                              else 256)
    got = radius_knn_cuda(pts, pts, cnt, sp.radius, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, radius_knn_plain(pts, pts, cnt, sp.radius, k, **kw))


def test_model_refuses_configs_beyond_the_kernels(cuda):
    cfg = make_tiny_cfg()
    with pytest.raises(ValueError, match=r"neighbor_limits\[0\] = 257"):
        RDMNet(dataclasses.replace(cfg, pyramid=dataclasses.replace(
            cfg.pyramid, neighbor_limits=(257, 16, 16, 16, 16))), device=cuda)
    with pytest.raises(ValueError, match=r"num_points_in_patch = 256"):
        RDMNet(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_points_in_patch=256)), device=cuda)
    RDMNet(dataclasses.replace(cfg, pyramid=dataclasses.replace(
        cfg.pyramid, neighbor_limits=(256,) * 5)), device=cuda)


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
    assert launch_counts() == {"radius_knn": 12, "sinkhorn": 1}
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
