"""``compute_dtype="bfloat16"`` in the PyTorch port against the JAX package's
bfloat16 path, on the CPU, with the same weights (flax inits carried across
by ``params_from_jax``) and the same seeded numpy inputs.

bfloat16 keeps about three significant digits, and the two libraries sum in
other orders, so a rounding to bfloat16 comes out one unit apart here and
there and the two bfloat16 runs part. The yardstick is JAX's own distance
from float32: ``rel(a, b) = |a - b| / |b|`` (Frobenius norms over valid
rows).

Bounds:
* one layer at a time (KPConv, the blocks, GroupNorm, the rotary attention
  layer dense and sparse top-k): the port's bfloat16 output is no further
  from JAX's bfloat16 output than JAX's bfloat16 output is from JAX's float32
  one (``rel(port16, jax16) <= rel(jax16, jax32)``; measured 0 to 0.86 of
  it, the attention layer highest: its float32 probabilities round to
  bfloat16 before the product with ``v``), and has JAX's output dtype;
* ThDRoFormer (a stack of four attention layers) and the whole model at
  ``make_tiny_cfg()``: within ``2 * rel(jax16, jax32)``. Two bfloat16 runs
  whose roundings part independently lie about sqrt(2) times as far from
  each other as each lies from float32; measured 1.10-1.18 (ThDRoFormer) and
  0.8-1.4 (the model's stages). For the model, every pyramid table equal. The port's
  bfloat16 coarse features against its float32 ones have median cosine >
  0.98 (what ``tests/test_bf16.py`` asks of JAX), and every weight stays
  float32. NMS masks, matches and poses are not compared: with random
  weights they hinge on near-ties that bfloat16 noise flips;
* one bfloat16 train step (the batch of ``test_torch_port_train.py``): every
  loss finite and within ``2 * |jax16 - jax32| + 1e-3`` of JAX's bfloat16
  step (measured 0.03-0.9 of it), ``grad_norm`` finite and within
  ``2 * |jax16 - jax32|`` of JAX's (measured 239.3 against JAX's 221.6 in
  bfloat16 and 195.9 in float32: the gradient's norm moves by 13% with the
  dtype), gradients and weights float32.

The port's side runs on one thread (see ``test_torch_port_model.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.engine import train_step as jts
from rdmnet_tpu.engine.trainer import batch_to_device as jax_batch_to_device
from rdmnet_tpu.graph.pyramid import build_pair_batch as jax_build_pair_batch
from rdmnet_tpu.graph.pyramid import pad_cloud as jax_pad_cloud
from rdmnet_tpu.models import RDMNet as JaxRDMNet
from rdmnet_tpu.nn import attention as jat
from rdmnet_tpu.nn import kpconv as jkp
from rdmnet_tpu.nn.thdroformer import ThDRoFormer as JaxThDRoFormer
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
from rdmnet_tpu_torch.graph.pyramid import pad_cloud
from rdmnet_tpu_torch.models import RDMNet, pipeline
from rdmnet_tpu_torch.nn import attention as tat
from rdmnet_tpu_torch.nn import kpconv as tkp
from rdmnet_tpu_torch.nn.precision import Dense, _MatmulF32, compute_dtype, matmul_f32
from rdmnet_tpu_torch.nn.thdroformer import ThDRoFormer
from rdmnet_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_port_model import _pairs
from tests.test_torch_port_train import LOSSES, _host_batch

BF16 = torch.bfloat16
CAP = 512
STACK_BOUND = 2.0  # stacks of layers: rel(port16, jax16) <= 2 rel(jax16, jax32)


def rel(a, b, valid=None) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if valid is not None:
        a, b = a[valid], b[valid]
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _arrays(tree):
    return jax.tree.map(np.asarray, tree)


def _module_case(jm16, jm32, tm, args, kwargs=None, port_kwargs=None):
    """(port bf16, JAX bf16, JAX f32) outputs as float32 numpy, plus the two
    output dtypes, for one module with JAX's init carried across."""
    kwargs = kwargs or {}
    variables = jax.jit(lambda *a: jm32.init(jax.random.PRNGKey(0), *a, **kwargs))(*args)
    tm.load_state_dict(params_from_jax(_arrays(variables)), strict=True)
    j16 = jax.jit(lambda v, *a: jm16.apply(v, *a, **kwargs))(variables, *args)
    j32 = jax.jit(lambda v, *a: jm32.apply(v, *a, **kwargs))(variables, *args)
    tkw = {k: torch.as_tensor(np.asarray(v)) for k, v in kwargs.items()}
    tkw.update(port_kwargs or {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        t16 = tm(*[torch.from_numpy(np.asarray(a)) for a in args], **tkw)
    torch.set_num_threads(threads)
    as_list = lambda x: list(x) if isinstance(x, tuple) else [x]  # noqa: E731
    return [(t.float().numpy(), np.asarray(j, np.float32), np.asarray(k, np.float32),
             t.dtype, str(j.dtype)) for t, j, k in zip(as_list(t16), as_list(j16), as_list(j32))]


def _check_module(cases, bound=1.0):
    for t16, j16, j32, tdt, jdt in cases:
        assert np.isfinite(t16).all()
        assert str(tdt).replace("torch.", "") == jdt, (tdt, jdt)
        gap, yard = rel(t16, j16), rel(j16, j32)
        assert 0 < yard and gap <= bound * yard, (gap, yard)


def _cloud(rng, n_s, n_q, h, cin):
    s_pts = (rng.rand(n_s, 3) * 4).astype(np.float32)
    q_pts = s_pts[:n_q] + 0.05
    nbr = rng.randint(0, n_s + 1, size=(n_q, h)).astype(np.int32)  # n_s = sentinel
    feats = rng.randn(n_s, cin).astype(np.float32)
    return feats, q_pts, s_pts, nbr, np.arange(n_q) < n_q - 5, np.arange(n_s) < n_s - 5


# ------------------------------------------------------------ one module at a time

def test_precision_helpers():
    with pytest.raises(ValueError, match="compute_dtype"):
        compute_dtype("float16")
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((5, 7), (7, 3)))
    # bf16 operands, float32 result: the float32 product of the rounded operands
    got = matmul_f32(a.to(BF16), b.to(BF16))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.to(BF16).float() @ b.to(BF16).float(), rtol=0, atol=0)
    assert matmul_f32(a, b).dtype == torch.float32
    dense = Dense(7, 3, dtype=BF16)
    assert dense.weight.dtype == torch.float32 and dense(a).dtype == BF16
    assert set(dense.state_dict()) == {"weight", "bias"}


@pytest.mark.parametrize("batched", [False, True])
def test_card_gemm_backward_is_the_widened_products(batched):
    """The card's bf16 GEMM (forward on the card only) takes the gradients of
    the CPU route, the float32 product of the widened operands, rounded to
    bf16: its backward run here under a forward of the widened product."""

    class Widened(_MatmulF32):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a.float() @ b.float()

    rng = np.random.RandomState(1)
    lead = (3,) if batched else ()
    a0, b0 = (torch.from_numpy(rng.randn(*lead, *s).astype(np.float32)).to(BF16)
              for s in ((5, 7), (7, 4)))
    g = torch.from_numpy(rng.randn(*lead, 5, 4).astype(np.float32))
    grads = []
    for fn in (Widened.apply, lambda a, b: a.float() @ b.float()):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        fn(a, b).backward(g)
        grads.append((a.grad, b.grad))
    for x, y in zip(*grads):
        assert x.dtype == BF16 and torch.equal(x, y)


def test_kpconv_bf16_matches_jax():
    feats, q_pts, s_pts, nbr, _, _ = _cloud(np.random.RandomState(1), 120, 60, 10, 32)
    _check_module(_module_case(jkp.KPConv(32, 48, dtype=jnp.bfloat16), jkp.KPConv(32, 48),
                               tkp.KPConv(32, 48, dtype=BF16), (feats, q_pts, s_pts, nbr)))


def test_masked_group_norm_bf16_matches_jax():
    feats, _, _, _, _, sm = _cloud(np.random.RandomState(2), 120, 60, 10, 64)
    _check_module(_module_case(jkp.MaskedGroupNorm(8, 64, dtype=jnp.bfloat16),
                               jkp.MaskedGroupNorm(8, 64), tkp.MaskedGroupNorm(8, 64, dtype=BF16),
                               (feats, sm)))


def test_unary_block_bf16_matches_jax():
    feats, _, _, _, _, sm = _cloud(np.random.RandomState(3), 120, 60, 10, 64)
    _check_module(_module_case(jkp.UnaryBlock(64, 96, 8, dtype=jnp.bfloat16),
                               jkp.UnaryBlock(64, 96, 8), tkp.UnaryBlock(64, 96, 8, dtype=BF16),
                               (feats, sm)))


def test_conv_block_ones_input_bf16_matches_jax():
    rng = np.random.RandomState(4)
    n, h = 100, 12
    pts = (rng.rand(n, 3) * 4).astype(np.float32)
    nbr = rng.randint(0, n + 1, size=(n, h)).astype(np.int32)
    mask = np.arange(n) < 90
    feats = mask[:, None].astype(np.float32)
    nbr_feats = (nbr < 90)[..., None].astype(np.float32)
    _check_module(_module_case(
        jkp.ConvBlock(1, 32, 15, 1.275, 0.6, 8, dtype=jnp.bfloat16),
        jkp.ConvBlock(1, 32, 15, 1.275, 0.6, 8),
        tkp.ConvBlock(1, 32, 15, 1.275, 0.6, 8, dtype=BF16),
        (feats, pts, pts, nbr, mask), kwargs={"nbr_feats": nbr_feats}))


@pytest.mark.parametrize("strided", [False, True])
def test_residual_block_bf16_matches_jax(strided):
    args = _cloud(np.random.RandomState(5), 120, 60 if strided else 120, 10, 32)
    _check_module(_module_case(
        jkp.ResidualBlock(32, 64, 15, 1.275, 0.6, 8, strided=strided, dtype=jnp.bfloat16),
        jkp.ResidualBlock(32, 64, 15, 1.275, 0.6, 8, strided=strided),
        tkp.ResidualBlock(32, 64, 15, 1.275, 0.6, 8, strided=strided, dtype=BF16), args))


@pytest.mark.parametrize("topk", [None, 12])
def test_rotary_layer_bf16_matches_jax(topk):
    rng = np.random.RandomState(6)
    n, d = 40, 32
    x = rng.randn(n, d).astype(np.float32)
    pos = rng.randn(n, d // 2).astype(np.float32)
    valid = rng.rand(n) > 0.2
    kwargs = {"memory_valid": valid}
    port_kwargs = {}
    if topk is not None:
        count = np.int32(9)  # ranks beyond 9 of the 12 kept carry no weight
        kwargs["topk_count"] = count
        port_kwargs["topk"] = topk
    _check_module(_module_case(
        jat.RotaryTransformerLayer(d, 4, topk=topk, dtype=jnp.bfloat16),
        jat.RotaryTransformerLayer(d, 4, topk=topk),
        tat.RotaryTransformerLayer(d, 4, dtype=BF16), (x, x, pos), kwargs, port_kwargs))


def test_thdroformer_bf16_matches_jax():
    rng = np.random.RandomState(9)
    n, m = 40, 32
    args = ((rng.rand(n, 3) * 30).astype(np.float32), (rng.rand(m, 3) * 30).astype(np.float32),
            rng.randn(n, 64).astype(np.float32), rng.randn(m, 64).astype(np.float32),
            rng.rand(n) > 0.2, rng.rand(m) > 0.2)
    cases = _module_case(JaxThDRoFormer(64, 48, 32, 4, 2, dtype=jnp.bfloat16),
                         JaxThDRoFormer(64, 48, 32, 4, 2),
                         ThDRoFormer(64, 48, 32, 4, 2, dtype=BF16), args)
    _check_module(cases, STACK_BOUND)
    assert all(c[3] == torch.float32 for c in cases)  # out_proj returns float32


# ------------------------------------------------------------ the whole model

STAGE_KEYS = ("ref_feats_c", "src_feats_c", "ref_n2p_scores_c", "src_n2p_scores_c",
              "ref_feats_f", "src_feats_f", "ref_p2p_scores_c", "ref_n2n_scores_c")


@pytest.fixture(scope="module")
def model_runs():
    """Pair A of ``test_torch_port_model.py`` through JAX float32 and
    bfloat16 and the port's float32 and bfloat16, one set of weights."""
    ref, src = _pairs()["A"]
    jcfg = jax_tiny_cfg()
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None))
    jb = jax.jit(lambda rp, rc, sp, sc: jax_build_pair_batch(rp, rc, sp, sc, jnp.eye(4),
                                                             jcfg.pyramid))(
        *jax_pad_cloud(jnp.asarray(ref), CAP), *jax_pad_cloud(jnp.asarray(src), CAP))
    j32 = JaxRDMNet(jcfg)
    j16 = JaxRDMNet(dataclasses.replace(jcfg, compute_dtype="bfloat16"))
    params = jax.jit(lambda b: j32.init(jax.random.PRNGKey(0), b, training=False,
                                        with_gt=False))(jb)
    jout = {name: _arrays(jax.jit(lambda p, b: m.apply(p, b, training=False, with_gt=False))(
        params, jb)) for name, m in (("32", j32), ("16", j16))}
    state = params_from_jax(_arrays(params))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tout, models = {}, {}
    for name, dt in (("32", "float32"), ("16", "bfloat16")):
        models[name] = RDMNet(dataclasses.replace(make_tiny_cfg(), compute_dtype=dt), device="cpu")
        models[name].load_state_dict(state, strict=True)
        tout[name] = pipeline(models[name], *pad_cloud(ref, CAP), *pad_cloud(src, CAP),
                              device="cpu")
    torch.set_num_threads(threads)
    return dict(jb=_arrays(jb), jout=jout, tout=tout, models=models)


def test_bf16_model_tables_equal_jax(model_runs):
    jb, tb = model_runs["jb"], model_runs["tout"]["16"]["batch"]
    for side in ("ref", "src"):
        jp, tp = getattr(jb, side), getattr(tb, side)
        for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
            for lvl, (j, t) in enumerate(zip(getattr(jp, field), getattr(tp, field))):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{side} {field}[{lvl}]")


@pytest.mark.parametrize("key", STAGE_KEYS)
def test_bf16_model_stage_within_bound(model_runs, key):
    jout, tout = model_runs["jout"], model_runs["tout"]
    valid = jout["32"]["nodes_ref_valid"] if key.endswith("_feats_c") else None
    t16 = tout["16"][key].numpy()
    assert tout["16"][key].dtype == torch.float32 and np.isfinite(t16).all()
    gap, yard = rel(t16, jout["16"][key], valid), rel(jout["16"][key], jout["32"][key], valid)
    assert 0 < yard and gap <= STACK_BOUND * yard, (gap, yard)


def test_bf16_model_close_to_port_float32(model_runs):
    t16, t32 = model_runs["tout"]["16"], model_runs["tout"]["32"]
    v = t32["nodes_ref_valid"].numpy()
    a, b = t16["ref_feats_c"].numpy()[v], t32["ref_feats_c"].numpy()[v]
    cos = np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-9)
    assert np.median(cos) > 0.98, float(np.median(cos))
    assert torch.isfinite(t16["estimated_transform"]).all()
    assert torch.isfinite(t16["matching_scores"]).all()


def test_bf16_weights_stay_float32(model_runs):
    model = model_runs["models"]["16"]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} <= {torch.float32}
    assert model.encoder.encoder1_1.KPConv.dtype == BF16
    assert model.transformer.in_proj.compute_dtype == BF16
    assert model.transformer2.out_proj.compute_dtype == BF16
    assert model.decoder.decoder4.norm.dtype == BF16


# ------------------------------------------------------------ one train step

@pytest.fixture(scope="module")
def train_runs():
    host = _host_batch()
    jcfg = jax_tiny_cfg()
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None))
    jbatch = jax_batch_to_device(host, jcfg.pyramid)
    single = jax.tree.map(lambda x: x[0], jbatch)
    state = jts.create_train_state(jcfg, jax.random.PRNGKey(0), single, steps_per_epoch=10)
    jm = {}
    for name, dt in (("32", "float32"), ("16", "bfloat16")):
        c = dataclasses.replace(jcfg, compute_dtype=dt)
        # the step runs the state's apply_fn: the model of the cfg it was built for
        st = state.replace(apply_fn=JaxRDMNet(c).apply)
        metrics, _ = jts.make_value_and_grad(c)(st, jbatch, jax.random.PRNGKey(1))
        jm[name] = jax.tree.map(float, metrics)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(make_tiny_cfg(), compute_dtype="bfloat16")
    model = RDMNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_arrays(state.params)), strict=True)
    tstate = create_train_state(cfg, model, steps_per_epoch=10)
    batch = batch_to_device(host, cfg.pyramid, device="cpu")
    tmetrics, tgrads = make_value_and_grad(cfg, device="cpu")(tstate, batch,
                                                               torch.Generator().manual_seed(1))
    applied = tstate.apply_gradients(tgrads)
    torch.set_num_threads(threads)
    return dict(jm=jm, tm={k: float(v) for k, v in tmetrics.items()}, grads=tgrads,
                applied=applied, model=model)


@pytest.mark.parametrize("key", LOSSES)
def test_bf16_train_step_losses_match_jax(train_runs, key):
    jm, tm = train_runs["jm"], train_runs["tm"]
    assert np.isfinite(tm[key])
    tol = 2 * abs(jm["16"][key] - jm["32"][key]) + 1e-3
    assert abs(tm[key] - jm["16"][key]) <= tol, (tm[key], jm["16"][key], jm["32"][key])


def test_bf16_train_step_gradient(train_runs):
    jm, tm = train_runs["jm"], train_runs["tm"]
    assert np.isfinite(tm["grad_norm"]) and tm["grad_norm"] > 0
    j16, j32 = jm["16"]["grad_norm"], jm["32"]["grad_norm"]
    assert 0 < abs(j16 - j32) and abs(tm["grad_norm"] - j16) <= STACK_BOUND * abs(j16 - j32)
    assert train_runs["applied"]
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in train_runs["grads"])
    assert {p.dtype for p in train_runs["model"].parameters()} == {torch.float32}
