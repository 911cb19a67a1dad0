"""The frozen arithmetic: FLOPs against FlopCounterMode over the port's own
pipeline, and the kernels' bounds against hand-worked values."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import bounds, flops, peaks
from benchmark.harness import scans
from benchmark.harness.weights import draw_weights, load_weights
from benchmark.reference import api
from benchmark.tests.tiny import tiny_config

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny():
    values = tiny_config()["config"]
    ref, src, _ = scans.pair_pool(5, 1, 2, 16, 200, 10.0, False, CPU)[0]
    return values, ref, src


def test_flops_equal_flopcountermode_over_the_port(tiny):
    from rdmnet_tpu_torch.config import Config, config_from_dict
    from rdmnet_tpu_torch.models import RDMNet, pipeline

    values, ref, src = tiny
    port_cfg = config_from_dict(Config, values)
    model = RDMNet(port_cfg, device="cpu")
    weights = draw_weights({n: tuple(p.shape) for n, p in model.named_parameters()}, 9, CPU)
    load_weights(model, weights)
    cap = port_cfg.pyramid.caps[0]
    (rp, rc), (sp, sc) = api.pad(ref, cap), api.pad(src, cap)
    counter = FlopCounterMode(display=False)
    with counter:
        pipeline(model, rp, np.int32(rc), sp, np.int32(sc), device="cpu")
    cfg = api.make_config(values)
    rmodel = api.make_model(cfg, weights, CPU)
    _, counted = flops.counted(lambda: api.serve_pair(rmodel, ref, src))
    assert counted == counter.get_total_flops() > 1e9


def test_share_of_peak():
    assert flops.share_of_peak(67e9, 10.0, peaks.F32_FLOPS) == pytest.approx(1.0)


def test_sinkhorn_bound_hand_worked():
    # 2 half-steps x 100 iterations x 256 patches x 129^2 entries, one exp each,
    # at 132 SMs x 16 a clock x 1.98 GHz
    want = 2 * 100 * 256 * 129 * 129 / (132 * 16 * 1.98e9) * 1e3
    assert bounds.sinkhorn_bound_ms(256, 129, 100) == pytest.approx(want)
    assert want == pytest.approx(0.203747, abs=1e-6)


def test_knn_bound_hand_worked():
    # one cloud of 64 rows: 32 at x=0 and 32 at x=100; 2 queries at x=0
    s = torch.zeros(1, 64, 3)
    s[0, 32:, 0] = 100.0
    q = torch.zeros(1, 2, 3)
    cnt = torch.tensor([64])
    window, reached = bounds.knn_work(q, s, cnt, torch.tensor([2]), 1.0)
    assert (window, reached) == (128, 64)  # the far chunk's box lies past the radius
    ms = bounds.knn_bound_ms(q, s, cnt, torch.tensor([2]), 1.0, k=8)
    by_bytes = (2 * 12 + 64 * 12 + 2 * 8 * 4) / 3.35e12 * 1e3
    by_ops = 64 * 9 / 67e12 * 1e3
    assert ms == pytest.approx(max(by_bytes, by_ops))


def test_knn_pair_bound_counts_twelve_searches(tiny):
    values, ref, src = tiny
    cfg = api.make_config(values)
    pts, cnts = api.pyramid(cfg, ref, src, CPU)
    total = bounds.knn_pair_bound_ms(cfg, pts, cnts)
    floor = sum(2 * (cfg.pyramid.caps[sp.q_lvl] * (12 + 4 * sp.k) + cfg.pyramid.caps[sp.s_lvl] * 12)
                for sp in __import__("benchmark.reference.graph.pyramid", fromlist=["x"])
                .search_plan(cfg.pyramid)) / 3.35e12 * 1e3
    assert total >= floor * (1 - 1e-9)
