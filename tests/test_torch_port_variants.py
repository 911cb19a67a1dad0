"""The other model families of the port against the JAX package's ``RDMNet``
on the CPU: the GeoTransformer and APE coarse transformers, and the model
without the vote layer (``model_use_vote=False``), at ``make_tiny_cfg()``
widths.

Weights are drawn by the port (seeded) and carried to JAX by
``params_to_jax``; the tree they make must equal, path for path and shape
for shape, the one ``RDMNet.init`` makes in JAX. The pair is a procedural
scan against a rigidly moved copy of itself (pair B of
``test_torch_port_model.py``).

Tolerances:
* pyramid tables are the main path's (``test_torch_port_model.py``); the
  NMS keep masks, node validity and patch masks: exact; the matched node
  pairs: the same set, and in the same order but where two scores tie to
  ~1e-7 (random weights make such near-ties, and float32 sums in another
  order swap them); the patches are compared in JAX's order;
* coarse features (``ref_feats_c`` / ``src_feats_c``, unit rows) within
  1e-5 on valid rows only: GeoTransformer's pad rows sit at sentinel
  coordinates whose distance indices reach ~1e8, where float32 sines differ
  between XLA and torch; pad keys are masked and pad rows never match;
* the log transport plan within 1e-4 (masked entries equal);
* the pose within 1e-4 where the JAX pose registers the pair (within 0.05
  of the known motion), else a finite rigid transform; each variant's
  weight draw registers it.

The port's side runs on one thread (see ``test_torch_port_model.py``).
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
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.graph.pyramid import pad_cloud
from rdmnet_tpu_torch.models import RDMNet, pipeline
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.utils.convert import params_to_jax

ANGLE, SHIFT = 0.05, np.array([0.5, 0.3, 0.1], np.float32)
MOTION = np.eye(4, dtype=np.float32)
MOTION[:2, :2] = [[np.cos(ANGLE), -np.sin(ANGLE)], [np.sin(ANGLE), np.cos(ANGLE)]]
MOTION[:3, 3] = SHIFT


def _family(kind):
    return lambda c: dataclasses.replace(c, model=dataclasses.replace(c.model, coarse_module=kind))


def _vote_off(c):
    return dataclasses.replace(c, vote=dataclasses.replace(c.vote, model_use_vote=False))


PATCH_KEYS = ("ref_node_corr_indices", "src_node_corr_indices", "ref_node_corr_knn_masks",
              "src_node_corr_knn_masks", "matching_scores")
VARIANTS = {"geotransformer": _family("geotransformer"), "ape": _family("ape"),
            "vote_off": _vote_off}
# a weight draw per variant whose JAX pose registers the pair, so the pose
# comparison is made (of seeds 0-3, geotransformer registers only with 2)
SEEDS = {"geotransformer": 2, "ape": 1, "vote_off": 0}


def moved_pair(cap=500):
    """A procedural scan (seeded subsample to the tiny capacity) and a
    rigidly moved copy: R src + t = ref under ``MOTION``."""
    scans, _ = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    ref = scans[0][np.random.RandomState(0).permutation(len(scans[0]))[:cap], :3]
    return ref, ((ref - SHIFT) @ MOTION[:3, :3]).astype(np.float32)


def jax_twin(cfg_fn, pyramid_scale=None):
    """(JAX config, port config) of one variant: the same replacements on
    both packages' tiny configs (field names agree); JAX searches exactly."""
    jcfg, tcfg = cfg_fn(jax_tiny_cfg()), cfg_fn(make_tiny_cfg())
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None))
    if pyramid_scale is not None:
        jcfg = dataclasses.replace(jcfg, pyramid=jcfg.pyramid.scaled(pyramid_scale))
        tcfg = dataclasses.replace(tcfg, pyramid=tcfg.pyramid.scaled(pyramid_scale))
    return jcfg, tcfg


def tree_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(tree_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v.shape)
    return out


def run_pair(cfg_fn, ref, src, seed=0, pyramid_scale=None, model=None, params=None):
    """The port's ``pipeline`` and JAX's build + apply (inference, no ground
    truth) on one pair with the port's seeded weights, or ``model`` and the
    JAX tree ``params`` when given. Returns (JAX outputs, port outputs, the
    JAX init tree's shapes, the JAX run's tree's)."""
    jcfg, tcfg = jax_twin(cfg_fn, pyramid_scale)
    cap = tcfg.pyramid.caps[0]
    if model is None:
        model = RDMNet(tcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    if params is None:
        params = params_to_jax(model)
    jmodel = JaxRDMNet(jcfg)
    batch = jax.jit(lambda rp, rc, sp, sc: jax_build_pair_batch(rp, rc, sp, sc, jnp.eye(4),
                                                                jcfg.pyramid))(
        *jax_pad_cloud(jnp.asarray(ref), cap), *jax_pad_cloud(jnp.asarray(src), cap))
    want = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False,
                                                with_gt=False), batch)
    jout = jax.tree.map(np.asarray, jax.jit(
        lambda p, b: jmodel.apply(p, b, training=False, with_gt=False))(params, batch))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        before = launch_counts()
        tout = pipeline(model, *pad_cloud(ref, cap), *pad_cloud(src, cap), device="cpu")
        assert launch_counts() == before  # CPU tensors never reach a kernel
    finally:
        torch.set_num_threads(threads)
    return jout, tout, tree_shapes(want["params"]), tree_shapes(params["params"])


def check_outputs(jout, tout, feat_atol=1e-5):
    """The exact and toleranced comparisons of the module docstring; returns
    the JAX pose's distance to the known motion."""
    for key in ("nodes_ref_valid", "nodes_src_valid", "ref_node_masks", "src_node_masks",
                "node_corr_valid"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    # the port's patch order mapped onto JAX's through the (ref, src) pairs
    n_src = jout["src_node_masks"].shape[0]
    keys = [np.asarray(o["ref_node_corr_indices"], np.int64) * n_src
            + np.asarray(o["src_node_corr_indices"]) for o in (jout, tout)]
    order = np.argsort(keys[1], kind="stable")[np.argsort(np.argsort(keys[0], kind="stable"))]
    np.testing.assert_array_equal(keys[1][order], keys[0], err_msg="matched node pairs")
    assert (order != np.arange(len(order))).sum() <= 4, "more than two near-ties swapped"
    tout = {k: (v[order] if k in PATCH_KEYS else v) for k, v in tout.items()}
    for key in ("ref_node_corr_knn_masks", "src_node_corr_knn_masks"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    for side in ("ref", "src"):
        valid = jout[f"nodes_{side}_valid"]
        np.testing.assert_allclose(tout[f"{side}_feats_c"].numpy()[valid],
                                   jout[f"{side}_feats_c"][valid], rtol=0, atol=feat_atol,
                                   err_msg=f"{side}_feats_c")
    got, want = tout["matching_scores"].numpy(), jout["matching_scores"]
    masked = want <= -1e11
    np.testing.assert_array_equal(got <= -1e11, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=1e-4, atol=1e-4)
    pose = tout["estimated_transform"].numpy()
    reg = float(np.abs(jout["estimated_transform"] - MOTION).max())
    if reg <= 0.05:
        np.testing.assert_allclose(pose, jout["estimated_transform"], rtol=1e-4, atol=1e-4)
    assert np.isfinite(pose).all()
    np.testing.assert_allclose(pose[:3, :3] @ pose[:3, :3].T, np.eye(3), atol=1e-5)
    return reg


@pytest.fixture(scope="module")
def runs():
    ref, src = moved_pair()
    return {name: run_pair(fn, ref, src, seed=SEEDS[name]) for name, fn in VARIANTS.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_tree_equals_jax_init(runs, variant):
    _, _, want, got = runs[variant]
    assert got == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(runs, variant):
    jout, tout, _, _ = runs[variant]
    assert check_outputs(jout, tout) <= 0.05  # registers: the poses were compared
    assert jout["node_corr_valid"].sum() > 10


def test_vote_off_has_no_vote_outputs(runs):
    jout, tout, _, got = runs["vote_off"]
    assert not any(p.startswith(("vote/", "transformer2/", "proj_n2n_score/")) for p in got)
    for key in ("shifted_ref_points_c", "ref_n2n_scores_c"):
        assert key not in tout and key not in jout
    # nodes are the coarse points, every valid one kept
    np.testing.assert_array_equal(tout["nodes_ref"].numpy(), tout["ref_points_c"].numpy())
    np.testing.assert_array_equal(tout["nodes_ref_valid"].numpy(), tout["ref_mask_c"].numpy())
    assert tout["nms_rounds"] == 0
