"""The whole slice: ``rdmnet_tpu_torch.models.pipeline`` against the JAX
package's ``build_pair_batch`` + ``RDMNet.apply(training=False,
with_gt=False)`` at ``make_tiny_cfg()``, same weights (flax init carried
across with ``params_from_jax``), same procedural input, on the CPU.

Tolerances:
* every pyramid table, ``dropped``, the NMS keep masks, the patch and
  superpoint indices and the correspondence points: exact;
* features, scores and the log transport plan: rtol/atol 1e-4 (float32 on
  both sides, other summation orders);
* ``estimated_transform``: 1e-4 on pair B (a scan against a rigidly moved
  copy of itself), whose correspondences determine the pose, and both
  recover the known motion. On two different frames with random weights
  (pair A) the winning per-patch hypothesis rests on two or three
  correspondences; its 4x4 Horn matrix has repeated top eigenvalues, so
  either eigensolver may return any rotation of that eigenspace. There the
  pose is only checked to be a finite rigid transform.

The port's side runs on one thread: torch's multithreaded CPU kernels do
not fix their summation order across processes (measured ~1e-4 feature
jitter between runs with 8 threads, none with 1), and such jitter can flip
an NMS or top-k decision that the exact checks above compare.
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
from rdmnet_tpu_torch.utils.convert import params_from_jax

CAP = 512
TOL = dict(rtol=1e-4, atol=1e-4)


# pair B's motion: src = R^T (ref - t), so that R src + t = ref
ANGLE, SHIFT = 0.05, np.array([0.5, 0.3, 0.1], np.float32)
MOTION = np.eye(4, dtype=np.float32)
MOTION[:2, :2] = [[np.cos(ANGLE), -np.sin(ANGLE)], [np.sin(ANGLE), np.cos(ANGLE)]]
MOTION[:3, 3] = SHIFT


def _pairs():
    """Pair A: two frames of a procedural sequence; pair B: frame 0 and a
    rigidly moved copy. Shrunk to the tiny level-0 capacity by a seeded
    subsample."""
    scans, _ = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    ref = scans[0][rng.permutation(len(scans[0]))[:500], :3]
    src = scans[1][rng.permutation(len(scans[1]))[:480], :3]
    moved = ((ref - SHIFT) @ MOTION[:3, :3]).astype(np.float32)
    return {"A": (ref, src), "B": (ref, moved)}


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_tiny_cfg()
    # the port always searches exactly; the JAX CPU approx path is exact too
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
    model = RDMNet(make_tiny_cfg(), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)

    # one thread: reproducible sums on the port's side (module docstring)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for name, (ref, src) in pairs.items():
        batch = build(*jax_pad_cloud(jnp.asarray(ref), CAP), *jax_pad_cloud(jnp.asarray(src), CAP))
        jout = jax.tree.map(np.asarray, apply(params, batch))
        before = launch_counts()
        tout = pipeline(model, *pad_cloud(ref, CAP), *pad_cloud(src, CAP), device="cpu")
        assert launch_counts() == before  # CPU tensors never reach a kernel
        out[name] = (jax.tree.map(np.asarray, batch), jout, tout)
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("pair", ["A", "B"])
def test_pyramid_tables_and_dropped_equal(runs, pair):
    jb, _, tout = runs[pair]
    tb = tout["batch"]
    for side in ("ref", "src"):
        jp, tp = getattr(jb, side), getattr(tb, side)
        for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
            for lvl, (j, t) in enumerate(zip(getattr(jp, field), getattr(tp, field))):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{side} {field}[{lvl}]")
        np.testing.assert_array_equal(tp.dropped.numpy(), jp.dropped)
    np.testing.assert_array_equal(
        tout["dropped"].numpy(), np.stack([jb.ref.dropped, jb.src.dropped]))


def test_backbone_and_transformer_features(runs):
    _, jout, tout = runs["A"]
    for key in ("ref_n2p_scores_c", "src_n2p_scores_c", "ref_feats_f", "src_feats_f",
                "ref_p2p_scores_c", "src_p2p_scores_c", "ref_n2n_scores_c", "nodes_ref",
                "nodes_src", "ref_feats_c", "src_feats_c"):
        np.testing.assert_allclose(tout[key].numpy(), jout[key], err_msg=key, **TOL)


@pytest.mark.parametrize("pair", ["A", "B"])
def test_nms_partition_and_matching_indices_equal(runs, pair):
    _, jout, tout = runs[pair]
    for key in ("nodes_ref_valid", "nodes_src_valid", "ref_node_masks", "src_node_masks",
                "ref_node_corr_indices", "src_node_corr_indices", "node_corr_valid",
                "ref_node_corr_knn_masks", "src_node_corr_knn_masks"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    assert 1 <= tout["nms_rounds"] < 32
    assert jout["nodes_ref_valid"].sum() < jout["nodes_ref_valid"].size  # NMS suppressed some


@pytest.mark.parametrize("pair", ["A", "B"])
def test_matching_scores_and_correspondences(runs, pair):
    _, jout, tout = runs[pair]
    got, want = tout["matching_scores"].numpy(), jout["matching_scores"]
    masked = want <= -1e11
    np.testing.assert_array_equal(got <= -1e11, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], **TOL)
    np.testing.assert_array_equal(tout["ref_corr_points"].numpy(), jout["ref_corr_points"])
    np.testing.assert_array_equal(tout["src_corr_points"].numpy(), jout["src_corr_points"])
    np.testing.assert_allclose(tout["corr_scores"].numpy(), jout["corr_scores"], **TOL)
    assert (jout["corr_scores"] > 0).sum() > 10


def test_estimated_transform(runs):
    _, jout_b, tout_b = runs["B"]
    np.testing.assert_allclose(tout_b["estimated_transform"].numpy(),
                               jout_b["estimated_transform"], **TOL)
    np.testing.assert_allclose(tout_b["estimated_transform"].numpy(), MOTION, atol=0.05)
    got = runs["A"][2]["estimated_transform"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3), atol=1e-5)
    np.testing.assert_array_equal(got[3], [0, 0, 0, 1])
