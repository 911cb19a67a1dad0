"""The port's two kernels: plain PyTorch versions against the JAX package,
on the CPU. The CUDA kernels against their plain versions are in
``test_torch_port_cuda.py`` (card only, no JAX).

Tolerances: Sinkhorn at rtol/atol 1e-4 — float32 log-domain iterations
whose sums run in another order than XLA's. Radius kNN: exact index
equality — the plain version reproduces the JAX package's float32 distance
rounding and its (distance, index) tie order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.nn.sinkhorn import LearnableLogOptimalTransport as JaxOT
from rdmnet_tpu.nn.sinkhorn import log_sinkhorn
from rdmnet_tpu.ops.pallas.radius_knn import radius_knn_pallas
from rdmnet_tpu.ops.pallas.sinkhorn import sinkhorn_pallas
from rdmnet_tpu.ops.radius_search import radius_knn as jax_radius_knn
from rdmnet_tpu.ops.radius_search import radius_knn_banded as jax_radius_knn_banded
from rdmnet_tpu_torch.nn.sinkhorn import LearnableLogOptimalTransport
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_cuda
from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn, sinkhorn_cuda, sinkhorn_plain
from rdmnet_tpu_torch.ops.radius_search import radius_knn, radius_knn_banded

T = torch.from_numpy


def _sinkhorn_inputs(seed, p=6, k1=17, masked=True):
    rng = np.random.RandomState(seed)
    s = rng.randn(p, k1, k1).astype(np.float32)
    mu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    nu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    if masked:
        # one fully masked patch (a padded correspondence) and masked rows
        s[0] = -1e12
        mu[0, :-1] = -1e12
        nu[0, :-1] = -1e12
        s[1, :5, :] = -1e12
        mu[1, :5] = -1e12
        s[2, :, 3:7] = -1e12
        nu[2, 3:7] = -1e12
    return s, mu, nu


def _assert_plan_close(got, want):
    masked = want <= -1e11
    np.testing.assert_array_equal(got <= -1e11, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_plain_matches_log_sinkhorn(masked):
    s, mu, nu = _sinkhorn_inputs(0, masked=masked)
    want = np.asarray(jax.jit(lambda a, b, c: log_sinkhorn(a, b, c, 30))(s, mu, nu))
    got = sinkhorn_plain(T(s), T(mu), T(nu), 30).numpy()
    assert np.isfinite(got).all()
    _assert_plan_close(got, want)


def test_sinkhorn_plain_matches_pallas_interpret():
    s, mu, nu = _sinkhorn_inputs(1, p=5)
    want = np.asarray(sinkhorn_pallas(jnp.asarray(s), jnp.asarray(mu), jnp.asarray(nu), 20,
                                      block_patches=8, interpret=True))
    got = sinkhorn_plain(T(s), T(mu), T(nu), 20).numpy()
    _assert_plan_close(got, want)


def test_sinkhorn_router_takes_plain_on_cpu():
    s, mu, nu = _sinkhorn_inputs(2)
    before = launch_counts()
    out = sinkhorn(T(s), T(mu), T(nu), 5)
    assert torch.equal(out, sinkhorn_plain(T(s), T(mu), T(nu), 5))
    assert launch_counts() == before


def test_optimal_transport_module_matches_jax():
    rng = np.random.RandomState(3)
    scores = rng.randn(4, 8, 8).astype(np.float32)
    row_valid = rng.rand(4, 8) > 0.2
    col_valid = rng.rand(4, 8) > 0.2
    row_valid[0] = False  # fully masked patch
    col_valid[0] = False
    jm = JaxOT(num_iterations=25)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(scores))
    params = jax.tree.map(lambda x: x * 0 + 0.7, params)  # non-default alpha
    want = np.asarray(jm.apply(params, jnp.asarray(scores), jnp.asarray(row_valid),
                               jnp.asarray(col_valid)))
    tm = LearnableLogOptimalTransport(25)
    with torch.no_grad():
        tm.alpha.fill_(0.7)
        got = tm(T(scores), T(row_valid), T(col_valid)).numpy()
    assert np.isfinite(got).all()
    _assert_plan_close(got, want)


def _lidar_like(seed, n, scale=(70.0, 30.0, 3.0)):
    """Points at LiDAR magnitudes, x-cell sorted (the pyramid's order)."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * np.asarray(scale) - np.asarray(scale) / 2).astype(np.float32)
    return pts[np.argsort(np.floor(pts[:, 0] / 0.6), kind="stable")]


@pytest.mark.parametrize("k", [1, 8, 24])
def test_radius_knn_plain_matches_jax_exact(k):
    pts = _lidar_like(4, 1500)
    q, s = pts[:700], pts
    radius = 2.55 if k == 1 else 2.0
    want = np.asarray(jax.jit(lambda q, s: jax_radius_knn(
        q, s, jnp.int32(1400), radius, k, chunk_size=256, approx_recall=None))(q, s))
    got = radius_knn(T(q), T(s), torch.tensor(1400), radius, k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 1400).any()
    assert k == 1 or (got == len(s)).any()  # some queries have < k neighbours


def test_radius_knn_plain_matches_pallas_interpret():
    rng = np.random.RandomState(5)
    q = (rng.rand(50, 3) * 6).astype(np.float32)
    s = (rng.rand(300, 3) * 6).astype(np.float32)
    want = np.asarray(radius_knn_pallas(jnp.asarray(q), jnp.asarray(s), jnp.int32(280), 1.0, 8,
                                        tile_q=16, block_s=64, interpret=True))
    got = radius_knn(T(q), T(s), torch.tensor(280), 1.0, 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("band_cap,expect_overflow", [(640, False), (192, True)])
def test_radius_knn_banded_matches_jax(band_cap, expect_overflow):
    pts = _lidar_like(6, 2048)
    q_count = 1900
    kw = dict(cell=0.6, band_cap=band_cap, chunk_size=128)
    want, want_ov = jax.jit(lambda q, s: jax_radius_knn_banded(
        q, s, jnp.int32(2000), 1.275, 16, q_count=jnp.int32(q_count),
        return_overflow=True, **kw))(pts, pts)
    got, got_ov = radius_knn_banded(T(pts), T(pts), torch.tensor(2000), 1.275, 16,
                                    q_count=torch.tensor(q_count), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_ov) == int(want_ov)
    assert (int(got_ov) > 0) == expect_overflow


def test_radius_knn_batched_and_k_beyond_support():
    """A batch of two clouds equals two single searches; k > S pads with S."""
    a, b = _lidar_like(7, 40, scale=(6.0, 6.0, 2.0)), _lidar_like(8, 40, scale=(6.0, 6.0, 2.0))
    both = radius_knn(T(np.stack([a, b])), T(np.stack([a, b])), torch.tensor([35, 40]), 3.0, 48)
    for i, (pts, cnt) in enumerate([(a, 35), (b, 40)]):
        want = np.asarray(jax.jit(lambda p: jax_radius_knn(
            p, p, jnp.int32(cnt), 3.0, 48, approx_recall=None))(pts))
        np.testing.assert_array_equal(both[i].numpy(), want)


def test_cuda_wrappers_refuse_cpu_tensors():
    s, mu, nu = _sinkhorn_inputs(12)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn_cuda(T(s), T(mu), T(nu), 3)
    pts = T(_lidar_like(13, 64))[None]
    with pytest.raises(ValueError, match="CUDA"):
        radius_knn_cuda(pts, pts, torch.tensor([64], dtype=torch.int32), 1.0, 4)
