"""Launch plans and the build cache of the port's CUDA kernels, on the CPU.

``knn_plan`` is the pure function that sizes every launch of
``csrc/radius_knn.cu``; these tests hold it to the kernel's limits for every
search of the graph build. No card, no JAX. The large-shape paths' plans
(k > 256, K1 > 208) are in ``test_torch_port_large_shapes.py``.
"""

from dataclasses import replace

import pytest

from rdmnet_tpu_torch.config import make_cfg, make_tiny_cfg
from rdmnet_tpu_torch.graph.pyramid import search_plan
from rdmnet_tpu_torch.ops.kernels import _build
from rdmnet_tpu_torch.ops.kernels.radius_knn import LIST_KMAX, knn_plan

PYRAMIDS = {
    "make_cfg": make_cfg().pyramid,
    "make_cfg_0.7": make_cfg().pyramid.scaled(0.7),
    "make_tiny_cfg": make_tiny_cfg().pyramid,
}
WINDOW_BYTES_MAX = 7168 * 16  # the 1.0 bucket's level-0 band as float4 rows


@pytest.mark.parametrize("k", [1, 16, 40, 48, 81, 128, 200, 256])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_knn_plan_fits_every_search(pyramid, k):
    spec = PYRAMIDS[pyramid]
    for sp in search_plan(spec):
        nq, ns = spec.caps[sp.q_lvl], spec.caps[sp.s_lvl]
        plan = knn_plan(2, nq, ns, k, sp.band)
        where = f"{sp.table}[{sp.q_lvl}->{sp.s_lvl}] k={k}: {plan}"
        assert sp.chunk % plan.warps == 0, where
        assert plan.k_bucket >= k and (plan.k_bucket == 1) == (k == 1), where
        assert plan.smem_bytes <= 232_448, where
        rows = ns if sp.band is None else sp.band
        assert plan.tiled == (rows * 16 > WINDOW_BYTES_MAX), where
        assert plan.smem_bytes == min(rows * 16, WINDOW_BYTES_MAX), where


def test_knn_plan_tiles_the_unbanded_level0_search():
    spec = PYRAMIDS["make_cfg_0.7"]
    plan = knn_plan(2, spec.caps[0], spec.caps[0], 40)
    assert plan.tiled and plan.smem_bytes == WINDOW_BYTES_MAX
    assert not knn_plan(2, spec.caps[0], spec.caps[0], 40, spec.band_caps[0]).tiled


def test_knn_plan_spreads_small_searches():
    """Fewer queries per block for small searches, so at least two blocks
    per SM where the search has the queries for it."""
    big, small = knn_plan(2, 21504, 21504, 40, 5120), knn_plan(2, 512, 512, 40)
    assert big.warps == 16 and small.warps == 4
    assert 2 * -(-1280 // knn_plan(2, 1280, 1280, 40).warps) >= 2 * 132


@pytest.mark.parametrize("k", [0, -1])
def test_knn_plan_refuses_k_out_of_range(k):
    with pytest.raises(ValueError, match="at least 1"):
        knn_plan(2, 64, 64, k)


def test_knn_plan_list_buckets():
    buckets = {k: knn_plan(2, 640, 640, k).k_bucket for k in (1, 2, 32, 33, 64, 65, 81, 128,
                                                              129, 200, 256)}
    assert buckets == {1: 1, 2: 32, 32: 32, 33: 64, 64: 64, 65: 128, 81: 128, 128: 128,
                       129: 256, 200: 256, 256: 256}
    assert LIST_KMAX == 256
    # one past the longest list: the select path, with no register list
    plan = knn_plan(2, 640, 640, 257)
    assert (plan.k_bucket, plan.sort_rows) == (0, 512)
    assert all(knn_plan(2, 640, 640, k).sort_rows == 0 for k in (1, 40, 256))


def test_model_builds_at_shapes_past_the_first_paths():
    """Configs the register list and the register Sinkhorn do not hold build
    (``RDMNet`` checks no kernel limit on any device), and every search of
    their graph build and their Sinkhorn get a launch plan."""
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.models import rdmnet
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_plan

    assert not hasattr(rdmnet, "check_kernel_limits")
    cfg = make_tiny_cfg()
    configs = [replace(cfg, pyramid=replace(cfg.pyramid, neighbor_limits=(16, 16, 257, 16, 16))),
               replace(cfg, pyramid=replace(cfg.pyramid, upsampling_limit=300)),
               replace(cfg, model=replace(cfg.model, num_points_in_patch=256)),
               replace(cfg, model=replace(cfg.model, num_points_in_patch=600))]
    for c in configs:
        RDMNet(c, device="cpu")
        for sp in search_plan(c.pyramid):
            plan = knn_plan(2, c.pyramid.caps[sp.q_lvl], c.pyramid.caps[sp.s_lvl], sp.k, sp.band)
            assert (plan.sort_rows > 0) == (sp.k > LIST_KMAX), (sp, plan)
            assert plan.smem_bytes <= 232_448 and sp.chunk % plan.warps == 0
        k1 = c.model.num_points_in_patch + 1
        assert sinkhorn_plan(k1).route == ("group" if k1 > 546 else "cluster" if k1 > 208
                                           else "register")


def test_library_path_covers_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("#define A 1\n")
    first = _build.library_path("k")
    header.write_text("#define A 2\n")
    assert _build.library_path("k") != first
    header.write_text("#define A 1\n")
    assert _build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("\n")
    assert _build.library_path("k") != first


@pytest.mark.parametrize("banded", [False, True])
def test_knn_work_counts_the_chunks_the_radius_reaches(banded):
    """``kernel_probe.knn_work``, which sets the kNN paths' bound: the valid
    rows of each valid query's window, and those of the window's 32-row
    chunks (from the window's first row) whose bounding box lies within the
    radius, against a direct count; every in-radius pair lies in such a
    chunk."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.radius_search import band_windows
    from rdmnet_tpu_torch.tools.kernel_probe import knn_bound, knn_work

    rng = np.random.RandomState(5)
    n, r, chunk, band = 1000, 0.7, 128, 512
    pts = (rng.rand(2, n, 3) * [6.0, 3.0, 2.0]).astype(np.float32)
    pts = np.stack([p[np.argsort(np.floor(p[:, 0] / 0.6), kind="stable")] for p in pts])
    s = torch.from_numpy(pts)
    cnt = torch.tensor([900, n], dtype=torch.int32)
    qcnt = torch.tensor([800, n], dtype=torch.int32)
    kw = {}
    if banded:
        win, _ = band_windows(s, s, qcnt, r, 0.6, band, chunk)
        kw = dict(win=win, chunk=chunk, band=band)
    window = reached = inside = 0
    for b in range(2):
        for qi in range(int(qcnt[b])):
            w = int(kw["win"][b, qi // chunk]) if banded else 0
            end = min(w + (band if banded else n), int(cnt[b]))
            q = pts[b, qi].astype(np.float64)
            for c0 in range(w, end, 32):
                rows = pts[b, c0:min(c0 + 32, end)].astype(np.float64)
                gap = np.maximum(rows.min(0) - q, 0) + np.maximum(q - rows.max(0), 0)
                near = ((rows - q) ** 2).sum(1) <= np.float32(r * r)
                window += len(rows)
                reached += len(rows) if (gap ** 2).sum() <= np.float32(r * r) else 0
                inside += int(near.sum())
    assert knn_work(s, s, cnt, qcnt, r, **kw) == (window, reached)
    assert inside <= reached < window
    ms, by, *pairs = knn_bound(s, s, cnt, qcnt, r, 320, **kw)
    assert pairs == [window, reached] and by in ("bytes", "operations") and ms > 0
