"""Seeded inputs: one seed gives the same traffic and weights, another seed
other ones."""

import numpy as np
import pytest
import torch

from benchmark.harness import scans, seeds
from benchmark.harness.drivers import register
from benchmark.harness.weights import draw_weights, family

CPU = torch.device("cpu")
BIG = 2 ** 31 + 12345  # seeds past 32 signed bits


def pool(seed):
    return scans.pair_pool(seed, 1, 3, 16, 200, 10.0, False, CPU)


def test_same_seed_same_pairs():
    a, b = pool(BIG), pool(BIG)
    assert len(a) == len(b) == 2
    for (r1, s1, t1), (r2, s2, t2) in zip(a, b):
        assert np.array_equal(r1, r2) and np.array_equal(s1, s2) and np.array_equal(t1, t2)


def test_other_seed_other_pairs():
    a, b = pool(BIG), pool(BIG + 1)
    assert not np.array_equal(a[0][0][:100], b[0][0][:100])


@pytest.mark.parametrize("enrich", [False, True])
def test_scans_are_lidar_like(enrich):
    frames, poses = scans.sequence(7, 2, 16, 400, 10.0, enrich, CPU)
    for scan in frames:
        assert scan.shape[1] == 4 and scan.dtype == np.float32 and len(scan) > 100
        assert np.isfinite(scan).all() and np.abs(scan[:, :3]).max() < 81.0
    assert 8.0 < np.linalg.norm(poses[1, :3, 3] - poses[0, :3, 3]) < 12.5


def test_request_order_is_seeded_and_covers_the_pool():
    a = register.request_order(5, BIG, 12)
    assert np.array_equal(a, register.request_order(5, BIG, 12))
    assert not np.array_equal(a, register.request_order(5, BIG + 1, 12))
    assert sorted(a[:5]) == list(range(5)) and sorted(a[5:10]) == list(range(5))


def kept(seed, n, k=12):
    r = register.Reservoir(k, seeds.rng(seed, "sample"))
    for i in range(n):
        r.offer(i)
    return r.items


def test_sample_is_seeded_and_uniform():
    assert kept(BIG, 100) == kept(BIG, 100) != kept(BIG + 1, 100)
    assert kept(BIG, 5) == list(range(5))
    assert len(set(kept(BIG, 1000))) == 12
    hits = np.zeros(40)
    for s in range(2000):
        hits[kept(s, 40, 4)] += 1
    assert hits.min() > 0.7 * 200 and hits.max() < 1.3 * 200  # each position ~4/40 of draws


def test_streams_differ():
    assert len({seeds.stream(BIG, s) for s in seeds.STREAMS}) == len(seeds.STREAMS)


def test_weights_seeded_and_in_their_families():
    shapes = {"a.weight": (4, 8), "k.weights": (15, 2, 3), "n.weight": (5,), "a.bias": (4,),
              "ot.alpha": ()}
    w1, w2 = draw_weights(shapes, BIG, CPU), draw_weights(shapes, BIG, CPU)
    w3 = draw_weights(shapes, BIG + 1, CPU)
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert w1["k.weights"].abs().max() <= (1.0 / 30) ** 0.5
    assert torch.equal(w1["n.weight"], torch.ones(5)) and torch.equal(w1["a.bias"], torch.zeros(4))
    assert float(w1["ot.alpha"]) == 1.0
    with pytest.raises(ValueError):
        family("x.running_mean", (3,))
