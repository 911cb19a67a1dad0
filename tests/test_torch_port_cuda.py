"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest configures JAX). Every test skips
on a host without a CUDA device. Tolerances: radius kNN indices exact (the
kernel rounds distances exactly as the plain version does), Sinkhorn at
rtol/atol 1e-4 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.graph.pyramid import pad_cloud
from rdmnet_tpu_torch.models import RDMNet, pipeline
from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_cuda, radius_knn_plain
from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda, sinkhorn_plain
from rdmnet_tpu_torch.ops.radius_search import band_windows

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
