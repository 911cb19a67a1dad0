"""Shapes past the kernels' first paths, on the CPU: radius kNN at k > 256
(the CUDA kernel's select paths) and Sinkhorn at K1 = num_points_in_patch + 1
> 208 (its cluster and group paths, the group path's bands spilled past
2640), the plain versions against
the JAX package, the tiny model at such shapes against JAX's, and the launch
plans of every path.
The CUDA paths against their plain versions are in ``test_torch_port_cuda.py``
(card only).

Tolerances, as in ``test_torch_port_kernels.py`` and
``test_torch_port_model.py``: radius kNN exact (the plain version reproduces
JAX's float32 distance rounding and its (distance, index) tie order);
Sinkhorn at rtol/atol 1e-4 (float32 log-domain iterations summed in another
order than XLA's); the tiny model's tables, node masks and indices exact, its
features, scores, plans and pose at rtol/atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.data.procedural import procedural_sequence
from rdmnet_tpu.graph.pyramid import build_pair_batch as jax_build_pair_batch
from rdmnet_tpu.graph.pyramid import pad_cloud as jax_pad_cloud
from rdmnet_tpu.models import RDMNet as JaxRDMNet
from rdmnet_tpu.ops.pallas.radius_knn import radius_knn_pallas
from rdmnet_tpu.ops.pallas.sinkhorn import sinkhorn_pallas
from rdmnet_tpu.ops.radius_search import radius_knn as jax_radius_knn
from rdmnet_tpu.ops.radius_search import radius_knn_banded as jax_radius_knn_banded
from rdmnet_tpu_torch.config import make_cfg, make_tiny_cfg
from rdmnet_tpu_torch.graph.pyramid import pad_cloud, search_plan
from rdmnet_tpu_torch.models import RDMNet, pipeline
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.ops.kernels.radius_knn import (BLOCK_CACHE_KEYS_MAX, BLOCK_K_MIN,
                                                     BLOCK_SORT_ROWS_MAX, LIST_KMAX,
                                                     SELECT_BLOCK_BYTES, SELECT_BOX_ROWS_MAX,
                                                     SMEM_MAX, WINDOW_ROWS_MAX, block_plan,
                                                     knn_plan, select_plan)
from rdmnet_tpu_torch.ops.kernels.sinkhorn import (CLUSTER_SIZES, GROUP_CTAS_MAX,
                                                   GROUP_K1_MAX, REGISTER_K1_MAX,
                                                   SinkhornPlan, cluster_cta_bytes,
                                                   group_cta_bytes, group_size, group_spill,
                                                   register_cta_bytes, sinkhorn_plain,
                                                   sinkhorn_plan)
from rdmnet_tpu_torch.ops.radius_search import radius_knn, radius_knn_banded
from rdmnet_tpu_torch.utils.convert import params_from_jax

T = torch.from_numpy
TOL = dict(rtol=1e-4, atol=1e-4)
LIMITS = (300, 16, 16, 16, 16)  # the tiny model's level-0 limit past the register list
PATCH = 256                     # num_points_in_patch: K1 = 257
GROUP_PATCH = 600               # num_points_in_patch: K1 = 601, the group path on the card
CAP = 512
SHRINK = np.float32(0.08)       # the tiny model's scans, scaled into a dense scene


def _dense(seed, n, box):
    """``n`` points uniform in a box, x-cell sorted (0.6 m, the pyramid's
    order): hundreds of rows inside a 2 m radius."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * np.asarray(box)).astype(np.float32)
    return pts[np.argsort(np.floor(pts[:, 0] / 0.6), kind="stable")]


# ------------------------------------------------------------ radius kNN

@pytest.mark.parametrize("k", [257, 300, 600])
def test_radius_knn_plain_matches_jax_exact_past_the_list(k):
    pts = _dense(1, 2000, (6.0, 3.0, 2.0))
    q, s = pts[:700], pts
    want = np.asarray(jax.jit(lambda q, s: jax_radius_knn(
        q, s, jnp.int32(1900), 2.0, k, chunk_size=256, approx_recall=None))(q, s))
    got = radius_knn(T(q), T(s), torch.tensor(1900), 2.0, k).numpy()
    np.testing.assert_array_equal(got, want)
    full = (got < len(s)).all(axis=1)
    assert full.mean() > 0.3 and (k < 600 or not full.all())  # lists fill; some run short


@pytest.mark.parametrize("k", [257, 300, 600])
@pytest.mark.parametrize("band_cap,expect_overflow", [(2560, False), (1536, True)])
def test_radius_knn_banded_matches_jax_past_the_list(k, band_cap, expect_overflow):
    pts = _dense(2, 4000, (12.0, 3.0, 2.0))
    q_count = 3900
    kw = dict(cell=0.6, band_cap=band_cap, chunk_size=128)
    want, want_ov = jax.jit(lambda q, s: jax_radius_knn_banded(
        q, s, jnp.int32(3950), 2.0, k, q_count=jnp.int32(q_count), return_overflow=True,
        **kw))(pts, pts)
    got, got_ov = radius_knn_banded(T(pts), T(pts), torch.tensor(3950), 2.0, k,
                                    q_count=torch.tensor(q_count), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_ov) == int(want_ov)
    assert (int(got_ov) > 0) == expect_overflow
    assert ((got.numpy() < len(pts)).all(axis=1)).mean() > 0.3


@pytest.mark.parametrize("k", [300, 600])
def test_radius_knn_batched_past_the_list_and_beyond_support(k):
    """A batch of two clouds equals two single searches at k > 256; the
    400-row cloud holds fewer rows than k, so its lists end in sentinels."""
    a, b = _dense(3, 400, (2.0, 2.0, 1.0)), _dense(4, 400, (2.5, 2.0, 1.0))
    both = radius_knn(T(np.stack([a, b])), T(np.stack([a, b])), torch.tensor([380, 400]), 2.0, k)
    for i, (pts, cnt) in enumerate([(a, 380), (b, 400)]):
        want = np.asarray(jax.jit(lambda p: jax_radius_knn(
            p, p, jnp.int32(cnt), 2.0, k, approx_recall=None))(pts))
        np.testing.assert_array_equal(both[i].numpy(), want)
    got = both.numpy()
    assert (got[..., LIST_KMAX] < 400).any()  # lists run past 256
    assert k < 400 or (got == 400).any(axis=-1).all()  # k above the support count


def test_radius_knn_plain_matches_pallas_interpret_at_k300():
    pts = _dense(5, 1024, (4.0, 3.0, 2.0))
    q = pts[::21][:48]
    want = np.asarray(radius_knn_pallas(jnp.asarray(q), jnp.asarray(pts), jnp.int32(1000), 2.0,
                                        300, tile_q=16, block_s=512, interpret=True))
    got = radius_knn(T(q), T(pts), torch.tensor(1000), 2.0, 300).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < len(pts)).all(axis=1).any()


# ------------------------------------------------------------ Sinkhorn

def _sinkhorn_inputs(seed, p, k1):
    rng = np.random.RandomState(seed)
    s = rng.randn(p, k1, k1).astype(np.float32)
    mu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    nu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    # a fully masked patch (a padded correspondence), masked rows and columns
    s[0] = -1e12
    mu[0, :-1] = -1e12
    nu[0, :-1] = -1e12
    s[1, :40, :] = -1e12
    mu[1, :40] = -1e12
    s[2, :, 30:90] = -1e12
    nu[2, 30:90] = -1e12
    return s, mu, nu


@pytest.mark.parametrize("k1", [209, 257, 600])
def test_sinkhorn_plain_matches_pallas_interpret_past_the_registers(k1):
    s, mu, nu = _sinkhorn_inputs(k1, 4, k1)
    want = np.asarray(sinkhorn_pallas(jnp.asarray(s), jnp.asarray(mu), jnp.asarray(nu), 10,
                                      block_patches=8, interpret=True))
    got = sinkhorn_plain(T(s), T(mu), T(nu), 10).numpy()
    assert np.isfinite(got).all()
    masked = want <= -1e11
    np.testing.assert_array_equal(got <= -1e11, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], **TOL)


# ------------------------------------------------------------ launch plans

@pytest.mark.parametrize("k", [257, 300, 320, 512, 600, 2048, 2049, 4096, 20000])
@pytest.mark.parametrize("rows", [512, 5120, 7168, 7169, 21504, 32768, 32769, 50000])
def test_knn_plan_select_path(k, rows):
    """Every k past the list takes a select path: below ``BLOCK_K_MIN`` the
    warp select path (a power-of-two sort buffer a warp holding the whole
    output, blocks of 16, 8 or 4 warps that fit in half an SM's shared
    memory beside the bounding boxes (32 bytes) of the window's 32-row
    chunks, tiled past 32768 rows), from it the block select path (a CTA of
    16 warps a query, no staged window, a key cache of the window's rows up
    to 8192 and a sort buffer of min(k, 4096) keys)."""
    for band in (None, rows):
        plan = knn_plan(2, 21504, 21504 if band else rows, k, band)
        sr = plan.sort_rows
        assert plan.k_bucket == 0 and sr & (sr - 1) == 0
        if k < BLOCK_K_MIN:
            assert plan.route == "select" and plan.cache_keys == 0
            assert sr == 1 << (k - 1).bit_length() >= k
            assert plan.warps in (4, 8, 16) and 64 % plan.warps == 0
            assert plan.tiled == (rows > SELECT_BOX_ROWS_MAX) and plan.tile_rows == 0
            assert plan.box_rows == min(-(-rows // 32) * 32, SELECT_BOX_ROWS_MAX)
            assert plan.smem_bytes == plan.box_rows // 32 * 32 + plan.warps * sr * 8
            assert plan.smem_bytes <= SELECT_BLOCK_BYTES <= SMEM_MAX // 2
            assert plan == select_plan(2, 21504, 21504 if band else rows, k, band)
        else:
            ck = plan.cache_keys
            assert plan.route == "block" and plan.warps == 16
            assert plan.tile_rows == plan.box_rows == 0 and ck & (ck - 1) == 0
            assert ck == min(1 << (rows - 1).bit_length(), BLOCK_CACHE_KEYS_MAX)
            assert sr == min(1 << (k - 1).bit_length(), BLOCK_SORT_ROWS_MAX)
            assert plan.tiled == (rows > ck)
            assert plan.smem_bytes == (ck + sr) * 8 + 16 * 256 * 4 <= SMEM_MAX
            assert plan == block_plan(2, 21504, 21504 if band else rows, k, band)


def test_knn_plan_select_path_spreads_and_fits():
    assert knn_plan(2, 21504, 21504, 320, 5120).warps == 16  # phase 16's level-0 search
    # below the threshold: a warp's sort buffer of 1024 keys (8 KB) beside
    # 8 KB of boxes, 8 warps a block, two blocks an SM
    top = knn_plan(2, 21504, 21504, BLOCK_K_MIN - 1, 8192)
    assert (top.route, top.warps, top.sort_rows, top.box_rows) == ("select", 8, 1024, 8192)
    assert knn_plan(1, 300, 300, 512).warps == 4             # too few queries to spread
    # k = 2048 takes the block select path: a CTA a query, two CTAs an SM
    big = knn_plan(2, 21504, 21504, 2048, 8192)
    assert (big.route, big.warps, big.cache_keys, big.sort_rows) == ("block", 16, 8192, 2048)
    assert 2 * (big.smem_bytes + 1024) <= 228 * 1024
    # the threshold: k <= 1024 (phase 16's k = 320 among them) stays on the
    # warp select path
    assert knn_plan(2, 21504, 21504, BLOCK_K_MIN - 1, 5120).route == "select"
    assert knn_plan(2, 21504, 21504, BLOCK_K_MIN, 5120).route == "block"
    assert BLOCK_K_MIN == 1025
    # the warp select path's own plan holds k to 2048 (4 warps of 2048 keys,
    # two blocks an SM), which the route tables time past the threshold
    wide = select_plan(2, 21504, 21504, 2048, 5120)
    assert (wide.warps, wide.sort_rows) == (4, 2048)
    with pytest.raises(ValueError, match="does not fit the warp select path"):
        select_plan(2, 21504, 21504, 2049, 5120)
    # the list path's plans are unchanged: the same buckets, no sort buffer
    assert knn_plan(2, 21504, 21504, LIST_KMAX, 5120) == knn_plan(2, 21504, 21504, 256, 5120)
    assert knn_plan(2, 21504, 21504, 40, 5120).sort_rows == 0
    assert knn_plan(2, 21504, 21504, 40, 5120).route == "list"


def _cluster_limits():
    """Each cluster size's last K1: where its CTA's bytes pass 232,448."""
    return {c: max(k1 for k1 in range(1, 2000) if cluster_cta_bytes(k1, c) <= SMEM_MAX)
            for c in CLUSTER_SIZES}


def test_cluster_limits_from_the_byte_count():
    """A band of ceil(K1 / C) float32 rows, 16 warps' (max, sum) column
    partials, two (max, sum) exchange buffers, v, and the band's log_mu and u."""
    assert cluster_cta_bytes(257, 2) == 4 * (129 * 257 + 37 * 257 + 2 * 129)
    assert _cluster_limits() == {2: 304, 4: 412, 8: 546}


def _group_ranges():
    """Each group size's first and last K1, from the byte count: the
    smallest G whose CTA fits in 232,448 bytes, K1 past the cluster path."""
    ranges = {}
    for k1 in range(_cluster_limits()[8] + 1, 4000):
        g = next((g for g in range(2, GROUP_CTAS_MAX + 1)
                  if group_cta_bytes(k1, g) <= SMEM_MAX), None)
        if g is None:
            break
        ranges.setdefault(g, [k1, k1])[1] = k1
    return ranges


@pytest.mark.parametrize("k1", [1, 17, 32, 33, 80, 81, 129, 144, 145, 208, 209, 257, 304, 305,
                                412, 413, 513, 546, 547, 576, 577, 600, 601, 623, 624, 1025,
                                2624, 2625, 2640, 2641, 3000, 4096, 4097])
def test_sinkhorn_plan_routes(k1):
    """The register path to K1 = 208; then the smallest cluster of 2, 4 or 8
    CTAs whose CTA fits in 232,448 bytes (the first and last K1 of each size
    among the cases); then the smallest group of G <= 132 CTAs whose CTA
    fits (the first and last K1 of G = 6, 7, 125 and 132 among the cases);
    past 2640, where no band of ceil(K1 / 132) rows fits, groups of G =
    ceil(K1 / B) CTAs of B = ceil(K1 / 132) rows, the rows that do not fit
    in a CTA's shared memory read from device memory (1 of 21 at 2641, 5 of
    23 at 3000, 19 of 32 at 4096 and at 4097)."""
    plan = sinkhorn_plan(k1)
    limits = _cluster_limits()
    if k1 <= REGISTER_K1_MAX:
        assert plan == SinkhornPlan("register", 0, 0, register_cta_bytes(k1))
    elif k1 <= limits[8]:
        c = next(c for c in CLUSTER_SIZES if k1 <= limits[c])
        assert plan == SinkhornPlan("cluster", 0, c, cluster_cta_bytes(k1, c))
        assert plan.cluster == {209: 2, 257: 2, 304: 2, 305: 4, 412: 4, 413: 8, 513: 8,
                                546: 8}[k1]
    elif k1 <= GROUP_K1_MAX:
        g = next(g for g in range(2, GROUP_CTAS_MAX + 1) if group_cta_bytes(k1, g) <= SMEM_MAX)
        # per resident group: G x K1 partials (max, sum) and K1 tagged v words
        assert plan == SinkhornPlan("group", 2 * (g + 1) * k1, 0, group_cta_bytes(k1, g), g)
        assert plan.group == {547: 6, 576: 6, 577: 7, 600: 7, 601: 7, 623: 7, 624: 8,
                              1025: 20, 2624: 125, 2625: 132, 2640: 132}[k1]
    else:
        band = -(-k1 // GROUP_CTAS_MAX)
        g, spill = -(-k1 // band), {2641: 1, 3000: 5, 4096: 19, 4097: 19}[k1]
        assert (g, spill) == group_spill(k1)
        assert g == {2641: 126, 3000: 131, 4096: 128, 4097: 129}[k1]
        assert plan == SinkhornPlan("group", 2 * (g + 1) * k1, 0,
                                    group_cta_bytes(k1, g, spill), g, spill)
        assert group_cta_bytes(k1, g, spill) <= SMEM_MAX < group_cta_bytes(k1, g, spill - 1)
        assert k1 - (g - 1) * band >= 1  # the last CTA's band is not empty
    assert sinkhorn_plan(129).route == "register"  # the main path's patch


@pytest.mark.parametrize("k1", [57216, 57217])
def test_group_spill_ends_where_v_passes_shared_memory(k1):
    """The group path's last K1 is 57216: a CTA of 132 there keeps none of
    its 434 rows, only v (57216 floats), u and log_mu, in 232,336 bytes; at
    57217 v rounds up to 57248 columns and the plan raises."""
    if k1 == 57216:
        assert group_spill(k1) == (132, 434)
        assert sinkhorn_plan(k1).cta_bytes == 4 * (57216 + 2 * 434) == 232_336 <= SMEM_MAX
    else:
        with pytest.raises(ValueError, match="does not fit the group path"):
            sinkhorn_plan(k1)


def test_group_sizes_from_the_byte_count():
    """A group-path CTA holds a band of ceil(K1 / G) rows of K1 rounded up to
    32 columns, v, and its rows' log_mu and u. Each G's first and last K1
    (G = 6 from K1 = 547, where the cluster path ends), the closed form of
    ``group_size`` against the search, no empty band, and the path's last
    K1: 2640, where 132 CTAs of 20 rows fit and 2641 would need 21."""
    assert group_cta_bytes(600, 7) == 4 * (86 * 608 + 608 + 2 * 86) == 212_272
    assert group_cta_bytes(2640, 132) == 4 * (20 * 2656 + 2656 + 40) == 223_264
    assert group_cta_bytes(2641, 132) > SMEM_MAX
    ranges = _group_ranges()
    assert max(r[1] for r in ranges.values()) == GROUP_K1_MAX == 2640
    assert {g: tuple(ranges[g]) for g in (6, 7, 8, 20, 125, 132)} == {
        6: (547, 576), 7: (577, 623), 8: (624, 672), 20: (1025, 1056), 125: (2605, 2624),
        132: (2625, 2640)}
    for g, (first, last) in ranges.items():
        for k1 in (first, last):
            b = -(-k1 // g)
            assert group_size(k1) == g and group_cta_bytes(k1, g) <= SMEM_MAX
            assert k1 - (g - 1) * b >= 1  # the last CTA's band is not empty
        assert group_cta_bytes(first, g - 1) > SMEM_MAX
    assert group_size(GROUP_K1_MAX + 1) == 0


@pytest.mark.parametrize("rows", [1, 31, 32, 300, 5120, 8192, 19200, 32768, 32769, 100000])
def test_warp_select_plan_fits_for_every_k(rows):
    """For every k the warp select path's plan holds (257 to 2048: the k the
    plan sends it, to ``BLOCK_K_MIN`` - 1, and those the route tables time
    past it), the plan's boxes (a 32-byte box a 32-row chunk, at most
    ``SELECT_BOX_ROWS_MAX`` rows at once) and 16, 8 or 4 warps' sort buffers
    of next_pow2(k) keys (the radix histogram's 1 KB laid over the first)
    fit in ``SELECT_BLOCK_BYTES``, so two blocks share an SM, for a search
    that spreads (16 warps at k <= 512, 8 to 1024, 4 above) and one that
    does not."""
    assert BLOCK_K_MIN - 1 <= 2048
    for k in range(LIST_KMAX + 1, 2049):
        for nq in (300, 21504):
            plan = select_plan(2, nq, 21504, k, rows)
            sr = plan.sort_rows
            assert sr == 1 << (k - 1).bit_length() and sr * 8 >= 256 * 4
            assert plan.box_rows % 32 == 0 and plan.box_rows >= min(rows, SELECT_BOX_ROWS_MAX)
            assert plan.tiled == (rows > plan.box_rows) and plan.tile_rows == 0
            assert plan.smem_bytes == plan.box_rows + plan.warps * sr * 8
            assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024 and plan.smem_bytes <= SMEM_MAX
            assert plan.warps == (4 if nq == 300 or k > 1024 else 16 if k <= 512 else 8), (k, plan)


def test_every_plan_fits_a_cta():
    """No plan of either kernel asks more than 232,448 bytes of shared memory
    of a CTA, at any K1 or k, window or query count."""
    for k1 in range(1, GROUP_K1_MAX + 200):
        assert sinkhorn_plan(k1).cta_bytes <= SMEM_MAX, k1
    for k1 in (2641, 3000, 4096, 8192, 20000, 50000, 57216):
        assert sinkhorn_plan(k1).cta_bytes <= SMEM_MAX, k1
    for k in (1, 16, 40, 64, 128, 256, 257, 320, 512, 513, 1024, 1025, 2048, 4096, 20000):
        for rows in (1, 64, 300, 4096, 5120, 7168, 7169, 8192, 8193, 21504, 100000):
            for nq in (1, 512, 21504):
                for band in (None, rows):
                    plan = knn_plan(2, nq, 21504 if band else rows, k, band)
                    assert plan.smem_bytes <= SMEM_MAX, (k, rows, nq, band, plan)


def test_sinkhorn_plan_refuses_empty_patch():
    with pytest.raises(ValueError, match="at least 1"):
        sinkhorn_plan(0)


def test_full_width_config_at_large_shapes_plans():
    """The configuration ``chip_smoke.py`` phase 16 runs: ``make_cfg()`` at the
    0.7 bucket with level-0 neighbour limit 320 and 256 points a patch. Its
    two level-0 searches take the warp select path, the other ten the list
    path as before, and its Sinkhorn the cluster path (2 CTAs a patch)."""
    cfg = make_cfg()
    pyr = dataclasses.replace(cfg.pyramid.scaled(0.7), neighbor_limits=(320, 40, 40, 40, 40))
    routes = []
    for sp in search_plan(pyr):
        plan = knn_plan(2, pyr.caps[sp.q_lvl], pyr.caps[sp.s_lvl], sp.k, sp.band)
        base = knn_plan(2, pyr.caps[sp.q_lvl], pyr.caps[sp.s_lvl], min(sp.k, 40), sp.band)
        routes.append(plan.sort_rows > 0)
        if sp.k <= LIST_KMAX:
            assert plan == base
    assert routes == [sp.k > LIST_KMAX for sp in search_plan(pyr)] and sum(routes) == 2
    assert all(knn_plan(2, pyr.caps[sp.q_lvl], pyr.caps[sp.s_lvl], sp.k, sp.band).route
               == "select" for sp in search_plan(pyr) if sp.k > LIST_KMAX)
    assert sinkhorn_plan(257) == ("cluster", 0, 2, cluster_cta_bytes(257, 2), 0, 0)


def test_full_width_config_at_the_group_path_plans():
    """The configuration of ``chip_smoke.py`` phase 16's group-path pass:
    ``make_cfg()`` at the 0.7 bucket with 600 points a patch (K1 = 601). Its
    12 searches keep the list path's plans, and its Sinkhorn takes the group
    path: 7 CTAs of 86 rows a patch, 212,272 bytes a CTA, so an H100 SXM (132
    SMs, one such CTA each) holds 18 groups and the 256 patches run in 15
    rounds."""
    cfg = make_cfg()
    pyr = cfg.pyramid.scaled(0.7)
    for sp in search_plan(pyr):
        plan = knn_plan(2, pyr.caps[sp.q_lvl], pyr.caps[sp.s_lvl], sp.k, sp.band)
        assert plan.route == "list" and plan.sort_rows == 0
    k1 = GROUP_PATCH + 1
    plan = sinkhorn_plan(k1)
    assert (plan.route, plan.group, plan.cta_bytes) == ("group", 7, 212_272)
    assert -(-k1 // plan.group) == 86
    groups = GROUP_CTAS_MAX // plan.group
    assert groups == 18 and -(-cfg.coarse_matching.num_correspondences // groups) == 15


# ------------------------------------------------------------ the tiny model

def _pairs():
    """Pair A: two frames of a procedural sequence; pair B: frame 0 and a
    rigidly moved copy (as in ``test_torch_port_model.py``). The scans are
    shrunk by ``SHRINK`` into a compact scene: at the 1.275 m search radius
    most level-0 neighbourhoods then hold 250-380 rows, so the level-0 lists
    of 300 fill past 256."""
    scans, _ = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    ref = scans[0][rng.permutation(len(scans[0]))[:500], :3] * SHRINK
    src = scans[1][rng.permutation(len(scans[1]))[:480], :3] * SHRINK
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    moved = ((ref - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)
    return {"A": (ref, src), "B": (ref, moved)}


def _large(cfg):
    return dataclasses.replace(
        cfg, pyramid=dataclasses.replace(cfg.pyramid, neighbor_limits=LIMITS),
        model=dataclasses.replace(cfg.model, num_points_in_patch=PATCH))


@pytest.fixture(scope="module")
def runs():
    jcfg = _large(jax_tiny_cfg())
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None))
    jmodel = JaxRDMNet(jcfg)

    @jax.jit
    def build(rp, rc, sp, sc):
        return jax_build_pair_batch(rp, rc, sp, sc, jnp.eye(4), jcfg.pyramid)

    apply = jax.jit(lambda p, b: jmodel.apply(p, b, training=False, with_gt=False))
    pairs = _pairs()
    jb = build(*jax_pad_cloud(jnp.asarray(pairs["A"][0]), CAP),
               *jax_pad_cloud(jnp.asarray(pairs["A"][1]), CAP))
    params = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False,
                                           with_gt=False))(jb)
    model = RDMNet(_large(make_tiny_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # reproducible sums (test_torch_port_model.py's docstring)
    out = {}
    for name, (ref, src) in pairs.items():
        batch = build(*jax_pad_cloud(jnp.asarray(ref), CAP), *jax_pad_cloud(jnp.asarray(src), CAP))
        jout = jax.tree.map(np.asarray, apply(params, batch))
        before = launch_counts()
        tout = pipeline(model, *pad_cloud(ref, CAP), *pad_cloud(src, CAP), device="cpu")
        assert launch_counts() == before
        out[name] = (jax.tree.map(np.asarray, batch), jout, tout)
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("pair", ["A", "B"])
def test_large_shape_model_tables_equal(runs, pair):
    jb, _, tout = runs[pair]
    tb = tout["batch"]
    for side in ("ref", "src"):
        jp, tp = getattr(jb, side), getattr(tb, side)
        for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
            for lvl, (j, t) in enumerate(zip(getattr(jp, field), getattr(tp, field))):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{side} {field}[{lvl}]")
    neighbors0 = tb.ref.neighbors[0].numpy()
    assert neighbors0.shape[1] == LIMITS[0]
    assert (neighbors0[:, LIST_KMAX] < CAP).any()  # some level-0 lists run past 256


@pytest.mark.parametrize("pair", ["A", "B"])
def test_large_shape_model_matching_and_plans(runs, pair):
    _, jout, tout = runs[pair]
    for key in ("ref_feats_f", "src_feats_f", "ref_feats_c", "src_feats_c"):
        np.testing.assert_allclose(tout[key].numpy(), jout[key], err_msg=key, **TOL)
    for key in ("nodes_ref_valid", "nodes_src_valid", "ref_node_corr_indices",
                "src_node_corr_indices", "node_corr_valid", "ref_node_corr_knn_masks",
                "src_node_corr_knn_masks"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    got, want = tout["matching_scores"].numpy(), jout["matching_scores"]
    assert got.shape[-1] == PATCH + 1
    masked = want <= -1e11
    np.testing.assert_array_equal(got <= -1e11, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], **TOL)
    np.testing.assert_array_equal(tout["ref_corr_points"].numpy(), jout["ref_corr_points"])
    np.testing.assert_allclose(tout["corr_scores"].numpy(), jout["corr_scores"], **TOL)


@pytest.fixture(scope="module")
def group_run():
    """Pair B through the tiny model at ``GROUP_PATCH`` points a patch (K1 =
    601: the card's group path) in both packages, the same weights."""
    jcfg = jax_tiny_cfg()
    jcfg = dataclasses.replace(
        jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None),
        model=dataclasses.replace(jcfg.model, num_points_in_patch=GROUP_PATCH))
    jmodel = JaxRDMNet(jcfg)
    ref, src = _pairs()["B"]
    batch = jax.jit(lambda rp, rc, sp, sc: jax_build_pair_batch(rp, rc, sp, sc, jnp.eye(4),
                                                                  jcfg.pyramid))(
        *jax_pad_cloud(jnp.asarray(ref), CAP), *jax_pad_cloud(jnp.asarray(src), CAP))
    params = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False,
                                           with_gt=False))(batch)
    jout = jax.tree.map(np.asarray, jax.jit(
        lambda p, b: jmodel.apply(p, b, training=False, with_gt=False))(params, batch))
    tcfg = make_tiny_cfg()
    model = RDMNet(dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, num_points_in_patch=GROUP_PATCH)),
        device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # reproducible sums (test_torch_port_model.py's docstring)
    tout = pipeline(model, *pad_cloud(ref, CAP), *pad_cloud(src, CAP), device="cpu")
    torch.set_num_threads(threads)
    return jout, tout


def test_group_path_model_matches_jax(group_run):
    """At K1 = 601 the tiny model's matched pairs, patch masks, log transport
    plans, correspondences and pose equal JAX's (plans and pose within
    1e-4)."""
    jout, tout = group_run
    assert sinkhorn_plan(GROUP_PATCH + 1).route == "group"
    for key in ("ref_node_corr_indices", "src_node_corr_indices", "node_corr_valid",
                "ref_node_corr_knn_masks", "src_node_corr_knn_masks"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    got, want = tout["matching_scores"].numpy(), jout["matching_scores"]
    assert got.shape[-1] == GROUP_PATCH + 1
    masked = want <= -1e11
    np.testing.assert_array_equal(got <= -1e11, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], **TOL)
    np.testing.assert_array_equal(tout["ref_corr_points"].numpy(), jout["ref_corr_points"])
    np.testing.assert_allclose(tout["estimated_transform"].numpy(), jout["estimated_transform"],
                               **TOL)


def test_large_shape_model_pose(runs):
    _, jout, tout = runs["B"]
    np.testing.assert_allclose(tout["estimated_transform"].numpy(), jout["estimated_transform"],
                               **TOL)
    assert np.isfinite(runs["A"][2]["estimated_transform"].numpy()).all()
