"""The port's upstream-checkpoint converter (``utils/torch_convert``) against
the JAX package's on the CPU, and ``make_parity_cfg`` against the JAX preset.

* Rule by rule: a hand-built upstream-schema state dict that hits every rule
  of the JAX ``_flax_path_and_kind`` at least once. The port's
  ``convert_state_dict`` equals ``params_from_jax`` of the JAX
  ``convert_state_dict`` key for key and value for value, exactly; the two
  exports into that schema are equal, ``div_term`` included; the
  ``module.`` prefix goes through both ``load_torch_checkpoint``s.
* Whole model, per family (ThDRoFormer dense and with ``k2``, APE,
  GeoTransformer) at ``make_tiny_cfg()`` widths: an upstream schema built
  in this test by inverting the rules over the model's keys (test code, not
  a package feature). Both exports equal; both imports equal and give back
  the weights exactly; the imported weights run to the same outputs in both
  packages (the tolerances of ``test_torch_port_variants.py``). APE's inner
  stack (``transformer.transformer.*``) has no upstream key: the
  ``transformer.transformer`` collapse maps upstream's nesting onto the
  ThDRoFormer layout, in both packages alike, so APE is held on the rest.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from rdmnet_tpu import config as jcfg
from rdmnet_tpu.utils import torch_convert as jconv
from rdmnet_tpu_torch import config as tcfg
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.utils import torch_convert as tconv
from rdmnet_tpu_torch.utils.convert import params_from_jax, params_to_jax
from test_torch_port_topk import _k2
from test_torch_port_variants import VARIANTS, check_outputs, moved_pair, run_pair

# every rule of the JAX _flax_path_and_kind, with the port key it lands on
# (None: dropped)
RULES = {
    # layers.N split, attention projections flattened, transformer.transformer
    "transformer.transformer.layers.0.attention.attention.proj_q.weight":
        ((8, 8), "transformer.self_0.attention.proj_q.weight"),
    "transformer.transformer.layers.1.attention.attention.proj_k.bias":
        ((8,), "transformer.cross_0.attention.proj_k.bias"),
    # the attention sub-layer's linear and norm onto the layer
    "transformer.transformer.layers.2.attention.linear.weight":
        ((8, 8), "transformer.self_1.linear.weight"),
    "transformer.transformer.layers.2.attention.norm.weight":
        ((8,), "transformer.self_1.norm.weight"),
    "transformer.transformer.layers.3.output.expand.weight":
        ((16, 8), "transformer.cross_1.output.expand.weight"),
    "transformer2.transformer.layers.0.attention.attention.proj_v.weight":
        ((8, 8), "transformer2.self_0.attention.proj_v.weight"),
    # div_term dropped: rotary and sinusoidal
    "transformer.transformer.layers.0.attention.attention.div_term": ((1, 1, 1, 4), None),
    "transformer.embedding.embedding.div_term": ((4,), None),
    # embedding.proj, norm.norm, norm_conv.norm collapses
    "transformer.embedding.proj.weight": ((4, 3), "transformer.embedding.weight"),
    "transformer.embedding.proj.bias": ((4,), "transformer.embedding.bias"),
    "encoder.encoder1_1.norm.norm.weight": ((4,), "encoder.encoder1_1.norm.weight"),
    "encoder.encoder1_2.norm_conv.norm.bias": ((4,), "encoder.encoder1_2.norm_conv.bias"),
    "decoder.decoder3.norm.norm.weight": ((4,), "decoder.decoder3.norm.weight"),
    # KPConv weights and kernel points verbatim
    "encoder.encoder1_1.KPConv.weights": ((15, 1, 4), "encoder.encoder1_1.KPConv.weights"),
    "encoder.encoder1_1.KPConv.kernel_points": ((15, 3), "encoder.encoder1_1.KPConv.kernel_points"),
    # vote MLP and output norm
    "vote.mlp_modules.0.weight": ((6, 8), "vote.mlp_0.weight"),
    "vote.mlp_modules.1.weight": ((6,), "vote.mlp_norm_0.weight"),
    "vote.mlp_modules.3.weight": ((5, 6), "vote.mlp_1.weight"),
    "vote.mlp_modules.4.bias": ((5,), "vote.mlp_norm_1.bias"),
    "vote.out_proj.1.weight": ((8,), "vote.out_norm.weight"),
    "vote.ctr_reg.weight": ((11, 5), "vote.ctr_reg.weight"),
    "optimal_transport.alpha": ((), "optimal_transport.alpha"),
    "proj_n2p_score.weight": ((1, 8), "proj_n2p_score.weight"),
}
FAMILIES = {"thdroformer": lambda c: c, "k2": _k2, "ape": VARIANTS["ape"],
            "geotransformer": VARIANTS["geotransformer"]}
DIV_TERMS = {"transformer.transformer.layers.0.attention.attention.div_term": (1, 1, 1, 32),
             "transformer.embedding.embedding.div_term": (64,)}


def _rule_dict():
    rng = np.random.RandomState(0)
    return {k: np.asarray(rng.randn(*shape), np.float32) for k, (shape, _) in RULES.items()}


def assert_state_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k in want:
        assert got[k].dtype == want[k].dtype and tuple(got[k].shape) == tuple(want[k].shape), k
        assert torch.equal(got[k], want[k]), k


def upstream_key(key: str) -> str:
    """A port ``state_dict`` key -> an upstream key that converts back to it
    (the rules inverted; the nested forms where upstream nests)."""
    parts = key.split(".")
    if parts[0] in ("transformer", "transformer2") and re.fullmatch(r"(self|cross)_\d+", parts[1]):
        kind, idx = parts[1].rsplit("_", 1)
        rest = parts[2:]
        if rest[0] in ("attention", "linear", "norm"):  # nested in upstream's attention
            rest = ["attention"] + rest
        n = 2 * int(idx) + (kind == "cross")
        return ".".join([parts[0], "transformer", "layers", str(n)] + rest)
    if parts[0] in ("encoder", "decoder") and parts[-2] in ("norm", "norm_conv"):
        return ".".join(parts[:-1] + ["norm", parts[-1]])
    if parts[0] == "vote":
        m = re.fullmatch(r"(mlp|mlp_norm)_(\d+)", parts[1])
        if m:
            seq = 3 * int(m[2]) + (m[1] == "mlp_norm")
            return ".".join(["vote", "mlp_modules", str(seq)] + parts[2:])
        if parts[1] == "out_norm":
            return ".".join(["vote", "out_proj", "1"] + parts[2:])
    return key


def family_schema(model):
    """(upstream {key: shape} schema, the model keys no upstream key reaches)."""
    schema, unreachable = {}, []
    for k, v in model.state_dict().items():
        up = upstream_key(k)
        if tconv.port_key_and_kind(up)[0] == k:
            schema[up] = tuple(v.shape)
        else:
            unreachable.append(k)
    schema.update(DIV_TERMS)
    return schema, unreachable


# ------------------------------------------------------------ rule by rule

def test_rule_dict_converts_like_jax():
    sd = _rule_dict()
    got = tconv.convert_state_dict(sd)
    want = params_from_jax(jconv.convert_state_dict(sd))
    assert_state_equal(got, want)
    assert set(got) == {port for _, port in RULES.values() if port is not None}
    for key, (_, port) in RULES.items():
        if port is not None:
            np.testing.assert_array_equal(got[port].numpy(), sd[key], err_msg=key)


def test_rule_dict_exports_like_jax():
    sd = _rule_dict()
    schema = {k: shape for k, (shape, _) in RULES.items()}
    got = tconv.export_state_dict(tconv.convert_state_dict(sd), schema)
    want = jconv.export_state_dict(jconv.convert_state_dict(sd), schema)
    assert set(got) == set(want) == set(schema)
    for k in schema:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if not k.endswith("div_term"):
            np.testing.assert_array_equal(got[k], sd[k], err_msg=k)


def test_module_prefix_and_blob_layouts(tmp_path):
    sd = _rule_dict()
    for i, blob in enumerate([
            {"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3},
            {"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
            {k: torch.from_numpy(v) for k, v in sd.items()}]):
        path = str(tmp_path / f"{i}.pth.tar")
        torch.save(blob, path)
        loaded = tconv.load_torch_checkpoint(path)
        assert set(loaded) == set(sd)
        got = tconv.convert_state_dict(loaded)
        assert_state_equal(got, params_from_jax(jconv.convert_state_dict(
            jconv.load_torch_checkpoint(path))))
    # convert_state_dict strips the prefix itself too
    assert_state_equal(tconv.convert_state_dict({f"module.{k}": v for k, v in sd.items()}),
                       tconv.convert_state_dict(sd))


def test_export_refuses_a_schema_the_model_lacks():
    state = tconv.convert_state_dict(_rule_dict())
    with pytest.raises(KeyError, match="has no"):
        tconv.export_state_dict(state, {"transformer.transformer.layers.9.output.expand.weight":
                                        (16, 8)})
    with pytest.raises(ValueError, match="shape"):
        tconv.export_state_dict(state, {"proj_n2p_score.weight": (2, 8)})
    with pytest.raises(ValueError, match="div_term"):
        tconv.export_state_dict(state, ["transformer.embedding.embedding.div_term"])


# ------------------------------------------------------------ whole model

@pytest.fixture(scope="module")
def models():
    out = {}
    for name, fn in FAMILIES.items():
        model = RDMNet(fn(make_tiny_cfg()), device="cpu", generator=torch.Generator().manual_seed(2))
        out[name] = (model, *family_schema(model))
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_schema_reaches_every_key_but_apes_inner_stack(models, family):
    model, schema, unreachable = models[family]
    if family == "ape":
        assert unreachable and all(k.startswith(("transformer.transformer.",
                                                 "transformer2.transformer.")) for k in unreachable)
    else:
        assert unreachable == []
    assert len(schema) == len(model.state_dict()) - len(unreachable) + len(DIV_TERMS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_exports_and_imports_like_jax(models, family):
    model, schema, _ = models[family]
    got = tconv.export_state_dict(model.state_dict(), schema)
    want = jconv.export_state_dict(params_to_jax(model)["params"], schema)
    assert set(got) == set(want) == set(schema)
    for k in schema:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    imported = tconv.convert_state_dict(got)
    assert_state_equal(imported, params_from_jax(jconv.convert_state_dict(want)))
    original = model.state_dict()
    assert_state_equal(imported, {k: original[k] for k in imported})


@pytest.mark.parametrize("family", ["thdroformer", "k2", "geotransformer"])
def test_imported_weights_run_alike(models, family):
    """The imported dict in both packages: the JAX tree is JAX's own import,
    the port's model loads its own strictly; both run the moved pair."""
    model, schema, _ = models[family]
    exported = tconv.export_state_dict(model.state_dict(), schema)
    cfg = FAMILIES[family](make_tiny_cfg())
    fresh = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    fresh.load_state_dict(tconv.convert_state_dict(exported), strict=True)
    params = {"params": jax.tree.map(np.asarray, jconv.convert_state_dict(exported))}
    ref, src = moved_pair()
    jout, tout, want_tree, got_tree = run_pair(FAMILIES[family], ref, src, model=fresh,
                                               params=params)
    assert got_tree == want_tree
    check_outputs(jout, tout)


# ------------------------------------------------------------ parity config

def test_parity_cfg_equals_the_jax_preset():
    tc, jc = tcfg.make_parity_cfg(), jcfg.make_parity_cfg()
    assert tc.pyramid.neighbor_limits == (65, 63, 69, 71, 81)
    assert tc.backbone.shared_influence is False and tc.vote.nms_neighbor_limit == 81
    for field in dataclasses.fields(tc):
        tsub, jsub = getattr(tc, field.name), getattr(jc, field.name)
        if not dataclasses.is_dataclass(tsub):
            assert tsub == jsub, field.name
            continue
        for f in dataclasses.fields(tsub):
            assert getattr(tsub, f.name) == getattr(jsub, f.name), (field.name, f.name)
    # the JAX-only fields: exact search is the port's only search
    assert jc.pyramid.approx_recall is None and not hasattr(tc.pyramid, "approx_recall")
    assert not hasattr(tc, "eval_matmul_precision")
