"""The port's layer factory and ``ConvBlock`` (``rdmnet_tpu_torch/nn/layers.py``)
against the JAX package's (``rdmnet_tpu/nn/layers.py``), and the converter's
conv-kernel and batch-statistics rules, on the CPU.

Weights are flax inits carried across with ``params_from_jax``. Outputs
agree within 1e-5 of max |y|; BatchNorm's running mean and variance within
1e-6 after a train step, and the eval step on them within 1e-5 of max |y|.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.nn import layers as jl
from rdmnet_tpu_torch.nn import layers as tl
from rdmnet_tpu_torch.utils.convert import params_from_jax, params_to_jax

T = torch.from_numpy

# conv cfg -> (input shape (batch, *spatial, C_in), kernel_size, stride, padding)
CONVS = {
    "Linear": ((2, 5, 6), None, 1, 0),
    "Conv1d": ((2, 11, 6), 3, 1, 1),
    "Conv2d": ((2, 8, 7, 6), 3, 2, "SAME"),   # uneven SAME padding at stride 2
    "Conv3d": ((2, 5, 6, 4, 6), 2, 1, "VALID"),
}
NORMS = [{"type": "GroupNorm", "num_groups": 4}, "LayerNorm", "BatchNorm2d", "InstanceNorm2d"]


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert got.shape == want.shape and err <= 1e-5 * scale, (what, err, scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_equal(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _draw(rng, path, shape):
    """A weight as an init would draw it, then moved: kernels at flax's fan-in
    scale, norm scales and biases, running means and variances away from 1
    and 0."""
    name = path[-1].key
    z = rng.randn(*shape)
    if name == "kernel":
        z = z / np.sqrt(np.prod(shape[:-1]))
    elif name in ("scale", "var"):
        z = 1.0 + 0.2 * np.abs(z)
    else:
        z = 0.2 * z
    return z.astype(np.float32)


def test_parse_cfg_and_activations():
    assert tl.parse_cfg("ReLU") == ("ReLU", {})
    assert tl.parse_cfg({"type": "LeakyReLU", "negative_slope": 0.1}) == (
        "LeakyReLU", {"negative_slope": 0.1})
    with pytest.raises(TypeError):
        tl.parse_cfg(3)
    x = np.linspace(-25, 25, 41).astype(np.float32)
    assert tl.build_act_layer(None)(T(x)) is not None
    for cfg in ("ReLU", "LeakyReLU", {"type": "LeakyReLU", "negative_slope": 0.1}, "ELU",
                "GELU", "Sigmoid", "Softplus", "Tanh", "Identity"):
        got = tl.build_act_layer(cfg)(T(x))
        want = jax.jit(jl.build_act_layer(cfg))(x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=str(cfg))
    with pytest.raises(ValueError):
        tl.build_act_layer("Swishish")


def test_dropout_noop_and_active():
    x = torch.ones(64, 8)
    for p in (None, 0, 0.0):
        assert tl.build_dropout_layer(p)(x, deterministic=False) is x
    drop = tl.build_dropout_layer(0.5)
    assert drop(x) is x  # deterministic by default
    with pytest.raises(ValueError, match="Generator"):
        drop(x, deterministic=False)
    y = drop(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert 0 < int(kept.sum()) < kept.numel()
    assert bool((y[kept] == 2.0).all())
    y2 = drop(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)  # the generator decides the mask


@pytest.mark.parametrize("act_before_norm", [False, True])
@pytest.mark.parametrize("norm", NORMS, ids=lambda n: n if isinstance(n, str) else n["type"])
@pytest.mark.parametrize("conv", list(CONVS))
def test_conv_block_matches_jax(conv, norm, act_before_norm):
    shape, ksize, stride, padding = CONVS[conv]
    kw = dict(in_channels=shape[-1], out_channels=8, conv_cfg=conv, kernel_size=ksize,
              stride=stride, padding=padding, norm_cfg=norm, act_cfg="LeakyReLU",
              act_before_norm=act_before_norm)
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    x2 = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    jblock = jl.ConvBlock(**kw)
    tblock = tl.ConvBlock(**kw)
    # the port's tree has flax's names and shapes (traced, not compiled: the
    # Conv3d initialisers take seconds to compile)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(1), x)
    assert jax.tree.map(lambda a: a.shape, params_to_jax(tblock)) == jax.tree.map(
        lambda a: a.shape, shapes)
    variables = jax.tree_util.tree_map_with_path(lambda path, a: _draw(rng, path, a.shape),
                                                 shapes)
    tblock.load_state_dict(params_from_jax(variables), strict=True)
    _tree_equal(params_to_jax(tblock), variables)  # the round trip

    is_bn = "BatchNorm" in str(norm)
    conv_name = "Dense_0" if conv == "Linear" else "Conv_0"
    assert ("bias" in variables["params"][conv_name]) == (act_before_norm or not (
        is_bn or "InstanceNorm" in str(norm)))
    if is_bn:
        train = jax.jit(functools.partial(jblock.apply, train=True, mutable=["batch_stats"]))
        want, mutated = train(variables, x)
        got = tblock(T(x), train=True)
        _close(got, want, "train")
        stats = params_to_jax(tblock)["batch_stats"]["BatchNorm_0"]
        for key in ("mean", "var"):
            np.testing.assert_allclose(stats[key], np.asarray(mutated["batch_stats"][
                "BatchNorm_0"][key]), rtol=0, atol=1e-6, err_msg=key)
        variables = dict(variables, batch_stats=_np(mutated["batch_stats"]))
    with torch.no_grad():
        got = tblock(T(x2), train=False)
    _close(got, jax.jit(functools.partial(jblock.apply, train=False))(variables, x2), "eval")


def test_converter_conv2d_3x2_kernel():
    """A flax Conv2d kernel (kh, kw, Cin, Cout) = (3, 2, 4, 5) becomes torch's
    (Cout, Cin, kh, kw); reversing every axis (a plain transpose) would give
    (5, 4, 2, 3)."""
    k = np.arange(3 * 2 * 4 * 5, dtype=np.float32).reshape(3, 2, 4, 5)
    state = params_from_jax({"Conv_0": {"kernel": k}})
    assert tuple(state["Conv_0.weight"].shape) == (5, 4, 3, 2)
    np.testing.assert_array_equal(state["Conv_0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    # the Dense and Conv1d rules are unchanged: both a plain transpose
    for shape in ((6, 7), (3, 6, 7)):
        arr = np.random.RandomState(0).randn(*shape).astype(np.float32)
        np.testing.assert_array_equal(params_from_jax({"m": {"kernel": arr}})["m.weight"].numpy(),
                                      arr.T)


class _ConvBN(fnn.Module):
    """ConvBlock's layout (Conv_0 -> BatchNorm_0 -> ReLU) with a 3x2 kernel,
    which the JAX ConvBlock (one int kernel_size) cannot express."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(5, kernel_size=(3, 2), strides=(2, 2), padding="SAME", use_bias=False)(x)
        x = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)(x, use_running_average=not train)
        return jax.nn.relu(x)


def test_conv2d_3x2_stride2_same_with_batchnorm():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 8, 4).astype(np.float32)
    jmod = _ConvBN()
    variables = _np(jax.jit(jmod.init)(jax.random.PRNGKey(0), x))
    tblock = tl.ConvBlock(4, 5, "Conv2d", kernel_size=(3, 2), stride=2, padding="SAME",
                          norm_cfg="BatchNorm2d", act_cfg="ReLU")
    tblock.load_state_dict(params_from_jax(variables), strict=True)
    want, mutated = jax.jit(functools.partial(jmod.apply, train=True,
                                              mutable=["batch_stats"]))(variables, x)
    got = tblock(T(x), train=True)
    assert tuple(got.shape) == (2, 5, 4, 5)
    _close(got, want, "train")
    stats = params_to_jax(tblock)["batch_stats"]["BatchNorm_0"]
    for key in ("mean", "var"):
        np.testing.assert_allclose(stats[key], np.asarray(mutated["batch_stats"]["BatchNorm_0"][
            key]), rtol=0, atol=1e-6)
    variables = dict(variables, batch_stats=_np(mutated["batch_stats"]))
    with torch.no_grad():
        got = tblock(T(x), train=False)
    _close(got, jax.jit(jmod.apply)(variables, x), "eval")


def test_converter_round_trip_conv_and_batch_stats():
    """params_to_jax(params_from_jax(v)) == v for a tree with Conv kernels of
    every rank and the batch_stats collection."""
    rng = np.random.RandomState(4)
    model = torch.nn.Module()
    model.a = tl.ConvBlock(3, 8, "Conv3d", kernel_size=2, norm_cfg="BatchNorm3d",
                           act_before_norm=True)
    model.b = tl.ConvBlock(8, 8, "Conv1d", kernel_size=3, norm_cfg={"type": "GroupNorm",
                                                                    "num_groups": 2})
    model.c = tl.ConvBlock(8, 4, "Linear", norm_cfg="LayerNorm")
    template = params_to_jax(model)
    variables = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), template)
    model.load_state_dict(params_from_jax(variables), strict=True)
    _tree_equal(params_to_jax(model), variables)
    assert template["params"]["a"]["Conv_0"]["kernel"].shape == (2, 2, 2, 3, 8)
    assert set(template["batch_stats"]["a"]["BatchNorm_0"]) == {"mean", "var"}


def test_norm_factory_instance_norm_semantics():
    norm = tl.build_norm_layer(4, "InstanceNorm1d")
    assert not list(norm.parameters())  # no affine by default, as torch's
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 32, 4).astype(np.float32))
    y = norm(x).numpy()
    np.testing.assert_allclose(y.mean(axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.std(axis=1), 1.0, atol=1e-3)
    with pytest.raises(ValueError):
        tl.build_norm_layer(4, "WeightNorm")
