"""Launch plans and the build cache of the port's CUDA kernels, on the CPU.

``knn_plan`` is the pure function that sizes every launch of
``csrc/radius_knn.cu``; these tests hold it to the kernel's limits for every
search of the graph build. No card, no JAX.
"""

from dataclasses import replace

import pytest

from rdmnet_tpu_torch.config import make_cfg, make_tiny_cfg
from rdmnet_tpu_torch.graph.pyramid import search_plan
from rdmnet_tpu_torch.ops.kernels import _build
from rdmnet_tpu_torch.ops.kernels.radius_knn import KMAX, knn_plan

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


@pytest.mark.parametrize("k", [0, KMAX + 1])
def test_knn_plan_refuses_k_out_of_range(k):
    with pytest.raises(ValueError, match="outside"):
        knn_plan(2, 64, 64, k)


def test_knn_plan_list_buckets():
    buckets = {k: knn_plan(2, 640, 640, k).k_bucket for k in (1, 2, 32, 33, 64, 65, 81, 128,
                                                              129, 200, 256)}
    assert buckets == {1: 1, 2: 32, 32: 32, 33: 64, 64: 64, 65: 128, 81: 128, 128: 128,
                       129: 256, 200: 256, 256: 256}
    assert KMAX == 256


def test_kernel_limits_raise_at_construction():
    """On a card ``RDMNet`` checks its config against the kernels' limits
    before building anything; here the check is called directly (the CPU
    runs the plain versions, which have no limits)."""
    from rdmnet_tpu_torch.config import make_parity_cfg
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.models.rdmnet import check_kernel_limits

    cfg = make_tiny_cfg()
    check_kernel_limits(make_parity_cfg())
    check_kernel_limits(replace(cfg, pyramid=replace(cfg.pyramid, neighbor_limits=(256,) * 5)))
    check_kernel_limits(replace(cfg, model=replace(cfg.model, num_points_in_patch=207)))
    big_k = replace(cfg, pyramid=replace(cfg.pyramid, neighbor_limits=(16, 16, 257, 16, 16)))
    with pytest.raises(ValueError, match=r"pyramid\.neighbor_limits\[2\] = 257.*k <= 256"):
        check_kernel_limits(big_k)
    with pytest.raises(ValueError, match=r"pyramid\.upsampling_limit = 300"):
        check_kernel_limits(replace(cfg, pyramid=replace(cfg.pyramid, upsampling_limit=300)))
    big_patch = replace(cfg, model=replace(cfg.model, num_points_in_patch=256))
    with pytest.raises(ValueError, match=r"model\.num_points_in_patch = 256.*<= 208"):
        check_kernel_limits(big_patch)
    for c in (big_k, big_patch):  # the CPU takes them
        RDMNet(c, device="cpu")


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
