"""Sparse top-k attention (ThDRoFormer's ``k2`` schedule) and the
conditional transformers of ``nn/transformers.py`` of the port against the
JAX package on the CPU.

* the vanilla, PE and LRPE conditional transformers, module by module, with
  flax's initial weights carried by ``params_from_jax`` and a quarter of the
  keys masked: outputs within 1e-5 (LRPE's indices run past its 64
  embeddings, which both clamp);

* ``attend`` with a static rank bound and a dynamic count against JAX
  ``_attend`` on the same inputs, with the count below the bound and most
  keys masked: masked keys tie at -1e9 and ``torch.topk`` may pick other
  ones than ``lax.top_k`` (lowest index first), but ranks at or beyond the
  count get zero weight, so the outputs agree (atol 1e-6).
* the whole model with ``k2=(0.5,)`` against JAX ``RDMNet`` at two capacity
  buckets (the rank bound comes from the padded capacity, so it changes
  with the bucket: 16 at the tiny coarse capacity 32, 64 at 128), with the
  tolerances of ``test_torch_port_variants.py``;
* one train step with ``k2`` against JAX ``make_value_and_grad``, with the
  tolerances of ``test_torch_port_variants_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.nn import transformers as jtr
from rdmnet_tpu.nn.attention import _attend as jax_attend
from rdmnet_tpu_torch.nn import transformers as ttr
from rdmnet_tpu_torch.nn.attention import attend
from rdmnet_tpu_torch.utils.convert import params_from_jax
from rdmnet_tpu_torch.nn.thdroformer import dyn_count, topk_schedule
from test_torch_port_variants import check_outputs, moved_pair, run_pair
from test_torch_port_variants_train import check_gradients, check_losses, run_step


BLOCKS = ("self", "cross", "self", "cross")


@pytest.mark.parametrize("kind", ["Vanilla", "PE", "LRPE"])
def test_conditional_transformers_match_jax(kind):
    rng = np.random.RandomState(3)
    n, m, d = 24, 20, 32
    ref, src = rng.randn(n, d).astype(np.float32), rng.randn(m, d).astype(np.float32)
    ref_valid, src_valid = rng.rand(n) > 0.25, rng.rand(m) > 0.25
    if kind == "PE":
        pos = (rng.randn(n, d).astype(np.float32), rng.randn(m, d).astype(np.float32))
    elif kind == "LRPE":
        pos = (rng.randint(0, 80, (n, n)).astype(np.int32), rng.randint(0, 80, (m, m)).astype(np.int32))
    else:
        pos = ()
    jmod = getattr(jtr, f"{kind}ConditionalTransformer")(BLOCKS, d, 4)
    jargs = [jnp.asarray(x) for x in (ref, src, *pos, ref_valid, src_valid)]
    params = jmod.init(jax.random.PRNGKey(0), *jargs)
    want = [np.asarray(x) for x in jmod.apply(params, *jargs)]
    tmod = getattr(ttr, f"{kind}ConditionalTransformer")(BLOCKS, d, 4)
    tmod.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(np.asarray(x)) for x in (ref, src, *pos, ref_valid,
                                                                src_valid)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


def _k2(c):
    return dataclasses.replace(c, thdroformer=dataclasses.replace(c.thdroformer, k2=(0.5,)))


@pytest.mark.parametrize("n_valid,topk,count", [(5, 16, 2), (30, 16, 15), (64, 8, 8)])
def test_attend_topk_matches_jax(n_valid, topk, count):
    rng = np.random.RandomState(n_valid)
    h, n, m, d = 4, 48, 64, 32
    q, k, v = (rng.randn(h, size, d).astype(np.float32) for size in (n, m, m))
    valid = np.zeros(m, bool)
    valid[rng.permutation(m)[:n_valid]] = True
    want = np.asarray(jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(valid), topk=topk, topk_count=jnp.int32(count)))
    got = attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(valid), topk=topk, topk_count=torch.tensor(count))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if count < topk:
        # the count matters: without it the masked ranks would carry weight
        loose = attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(valid), topk=topk)
        assert not torch.allclose(loose, got, atol=1e-3)


def test_attend_topk_gradient_reaches_kept_keys_only():
    torch.manual_seed(0)
    q, k, v = (torch.randn(2, 6, 8, requires_grad=True) for _ in range(3))
    out = attend(q, k, v, None, topk=2)
    out.sum().backward()
    # each query mixes two values: the other four rows of v get no gradient
    # from it, and every row of k gets one only through the kept scores
    assert torch.isfinite(k.grad).all() and (v.grad.abs().sum(-1) > 0).any()


def test_schedule_matches_the_jax_rule():
    assert [topk_schedule(cap, 0.5) for cap in (1, 32, 128, 512)] == [1, 16, 64, 256]
    valid = torch.zeros(32, dtype=torch.bool)
    valid[:7] = True
    assert int(dyn_count(valid, 0.5, 16)) == 3
    assert int(dyn_count(torch.zeros(32, dtype=torch.bool), 0.5, 16)) == 1
    assert int(dyn_count(torch.ones(32, dtype=torch.bool), 0.9, 16)) == 16


@pytest.fixture(scope="module")
def runs():
    ref, src = moved_pair()
    # weights of seed 2 register the pair at both buckets (of seeds 0-5, 2
    # and 5 do), so the poses are compared
    return {scale: run_pair(_k2, ref, src, seed=2, pyramid_scale=scale) for scale in (None, 2.0)}


@pytest.mark.parametrize("scale", [None, 2.0])
def test_k2_model_matches_jax_at_two_buckets(runs, scale):
    jout, tout, want_tree, got_tree = runs[scale]
    assert got_tree == want_tree
    assert check_outputs(jout, tout) <= 0.05
    cap = tout["ref_points_c"].shape[0]
    assert cap == (32 if scale is None else 128)
    # at the larger bucket fewer nodes survive NMS than the rank bound, so
    # masked keys fill the top-k and the count decides
    if scale == 2.0:
        assert int(tout["nodes_ref_valid"].sum()) < topk_schedule(cap, 0.5)


def test_k2_train_step_matches_jax():
    run = run_step(_k2)
    check_losses(run)
    check_gradients(run)
