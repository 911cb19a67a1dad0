"""``utils/golden.py``, ``utils/contracts.py``, ``models.create_model`` and
``engine.train_step.make_batch_loss`` of the port against the JAX package,
on the CPU.

* The splitter: a ``make_tiny_cfg()`` procedural pair's pyramid repacked
  into the reference's stacked layout by ``stack_pair_batch`` (valid rows
  packed, sentinel = the level's total) and split by both packages: every point,
  count and table equal; then each package's forward on its own split, with
  the same weights, at the model tests' tolerances (tables and masks exact,
  features and log transport plans 1e-4, the pose 1e-4 on a pair whose
  correspondences determine it: a scan against a rigidly moved copy).
* The contracts on the CPU: three ``pass``; each contract's inputs through the
  JAX counterparts (the Pallas kNN in interpret mode gives the port's plain
  table; ``log_sinkhorn`` within 1e-5; the Horn pose's rotation within 1e-5
  and its translation within 1e-5 of the scan's extent, the float32 rounding
  of centroids of 70 m coordinates); a corrupted kNN table gives ``FAIL``.
* ``make_batch_loss`` against ``make_value_and_grad``'s metrics on the same
  pairs and generator state: equal (the same float32 sums).
* The golden end-to-end comparison against the reference's dump skips while
  ``.cache/golden_e2e.npz`` is absent (``scripts/dump_reference_golden.py``
  makes it from the upstream sources); it never generates the dump.

The port's side runs on one thread (see ``test_torch_port_model.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.data.procedural import procedural_sequence
from rdmnet_tpu.models import RDMNet as JaxRDMNet
from rdmnet_tpu.nn.sinkhorn import log_sinkhorn as jax_log_sinkhorn
from rdmnet_tpu.ops.geometry import apply_transform as jax_apply_transform
from rdmnet_tpu.ops.pallas.radius_knn import radius_knn_pallas
from rdmnet_tpu.ops.procrustes import weighted_procrustes as jax_procrustes
from rdmnet_tpu.utils.golden import pair_batch_from_stacked as jax_split
from rdmnet_tpu_torch.config import make_parity_cfg, make_tiny_cfg
from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
from rdmnet_tpu_torch.engine.train_step import make_batch_loss
from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud
from rdmnet_tpu_torch.models import RDMNet, create_model
from rdmnet_tpu_torch.nn.sinkhorn import log_sinkhorn
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_plain
from rdmnet_tpu_torch.ops.procrustes import weighted_procrustes
from rdmnet_tpu_torch.utils import contracts
from rdmnet_tpu_torch.utils.convert import params_from_jax
from rdmnet_tpu_torch.utils.golden import (load_golden_npz, pair_batch_from_stacked,
                                           stack_pair_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, ".cache", "golden_e2e.npz")
CAP = 512
TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("points", "counts", "neighbors", "subsampling", "upsampling")


# ---------------------------------------------------------------- the splitter

def _moved_pair():
    """A scan (subsampled to the tiny capacity) against a rigidly moved copy,
    and the motion (src -> ref)."""
    scans, _ = procedural_sequence(11, 1, n_rings=16, n_azimuths=200)
    ref = scans[0][np.random.RandomState(0).permutation(len(scans[0]))[:500], :3]
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    src = ((ref - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)
    return ref, src, motion


@pytest.fixture(scope="module")
def split_runs():
    jcfg = jax_tiny_cfg()
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None))
    ref, src, motion = _moved_pair()
    built = build_pair_batch(*pad_cloud(ref, CAP), *pad_cloud(src, CAP), torch.eye(4),
                             make_tiny_cfg().pyramid)  # equal to JAX's (test_torch_port_model)
    graph = stack_pair_batch(built)
    jbatch = jax_split(**graph, transform=motion)
    tbatch = pair_batch_from_stacked(**graph, transform=motion, device="cpu")

    jmodel = JaxRDMNet(jcfg)
    params = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False,
                                           with_gt=False))(jbatch)
    jout = jax.tree.map(np.asarray, jax.jit(
        lambda p, b: jmodel.apply(p, b, training=False, with_gt=False))(params, jbatch))
    model = create_model(make_tiny_cfg(), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = launch_counts()
    with torch.no_grad():
        tout = model(tbatch, training=False, with_gt=False)
    assert launch_counts() == before  # CPU tensors never reach a kernel
    torch.set_num_threads(threads)
    return dict(graph=graph, built=built, jbatch=jax.tree.map(np.asarray, jbatch), tbatch=tbatch,
                jout=jout, tout=tout, motion=motion)


def test_split_tables_equal_jax(split_runs):
    jb, tb, graph = split_runs["jbatch"], split_runs["tbatch"], split_runs["graph"]
    for side in ("ref", "src"):
        jp, tp = getattr(jb, side), getattr(tb, side)
        for field in FIELDS:
            for lvl, (j, t) in enumerate(zip(getattr(jp, field), getattr(tp, field))):
                assert t.dtype in (torch.float32, torch.int32), (field, t.dtype)
                np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{side} {field}[{lvl}]")
        np.testing.assert_array_equal(tp.dropped.numpy(), jp.dropped)
    for name in ("ref_feats", "src_feats", "transform"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), getattr(jb, name), err_msg=name)
    # capacities round8(max(ref_n, src_n)): below the build's, so the split is
    # a different padding of the same graph
    caps = [tb.ref.points[i].shape[0] for i in range(len(graph["points"]))]
    assert caps == [max(8, -(-int(max(n)) // 8) * 8) for n in graph["lengths"]]
    assert caps[0] < CAP


def test_split_inverts_stack(split_runs):
    """pair_batch_from_stacked(stack_pair_batch(b)) holds b's valid rows and
    their tables, the sentinel moved to the new capacity."""
    built, split = split_runs["built"], split_runs["tbatch"]
    for side in ("ref", "src"):
        a, b = getattr(built, side), getattr(split, side)
        for lvl in range(len(a.points)):
            n = int(a.counts[lvl])
            assert int(b.counts[lvl]) == n
            assert torch.equal(a.points[lvl][:n], b.points[lvl][:n])
        for field, off in (("neighbors", 0), ("subsampling", 0), ("upsampling", 1)):
            for lvl, (ta, tb) in enumerate(zip(getattr(a, field), getattr(b, field))):
                q = lvl + 1 if field == "subsampling" else lvl
                s = lvl + off
                nq, cap_a, cap_b = int(a.counts[q]), a.points[s].shape[0], b.points[s].shape[0]
                want = torch.where(ta[:nq] < int(a.counts[s]), ta[:nq], torch.full_like(ta[:nq], cap_b))
                assert torch.equal(tb[:nq], want.to(tb.dtype)), (side, field, lvl, cap_a)


def test_forward_on_split_equals_jax(split_runs):
    jout, tout = split_runs["jout"], split_runs["tout"]
    for key in ("nodes_ref_valid", "nodes_src_valid", "ref_node_corr_indices",
                "src_node_corr_indices", "node_corr_valid"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    for key in ("ref_feats_f", "src_feats_f", "ref_feats_c", "src_feats_c"):
        np.testing.assert_allclose(tout[key].numpy(), jout[key], err_msg=key, **TOL)
    live = jout["matching_scores"] > -1e11
    np.testing.assert_array_equal(tout["matching_scores"].numpy() > -1e11, live)
    np.testing.assert_allclose(tout["matching_scores"].numpy()[live],
                               jout["matching_scores"][live], **TOL)
    tf = tout["estimated_transform"].numpy()
    np.testing.assert_allclose(tf, jout["estimated_transform"], **TOL)
    assert np.abs(tf - split_runs["motion"]).max() < 0.05  # both register the pair


# ---------------------------------------------------------------- the contracts

@pytest.fixture(scope="module")
def scan():
    return contracts.default_scan()


def test_contracts_pass_on_cpu():
    before = launch_counts()
    assert contracts.run_fast_contracts(device="cpu") == {
        "knn_exact": "pass", "sinkhorn": "pass", "horn_pose_recovery": "pass"}
    assert launch_counts() == before


def test_contract_inputs_through_jax(scan):
    n_q, n_s, count = contracts.KNN_QUERIES, contracts.KNN_SUPPORT, contracts.KNN_COUNT
    q, s = scan[:n_q], scan[:n_s]
    want = np.asarray(jax.jit(lambda q, s: radius_knn_pallas(
        q, s, jnp.int32(count), contracts.KNN_RADIUS, contracts.KNN_K, interpret=True))(q, s))
    got = radius_knn_plain(torch.from_numpy(q)[None], torch.from_numpy(s)[None],
                           torch.tensor([count]), contracts.KNN_RADIUS, contracts.KNN_K)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert contracts.knn_violations(got.numpy(), scan) == 0
    assert int((got < n_s).sum()) > n_q * contracts.KNN_K // 2  # the rows are not empty

    args = contracts.sinkhorn_inputs()
    want = jax.jit(lambda *a: jax_log_sinkhorn(*a, contracts.SINKHORN_ITERS))(*args)
    got = log_sinkhorn(*(torch.from_numpy(a) for a in args), contracts.SINKHORN_ITERS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    gt = contracts.pose_gt()
    src = scan[:contracts.POSE_POINTS]

    @jax.jit
    def recover(src):
        with jax.default_matmul_precision("highest"):
            return jax_procrustes(src, jax_apply_transform(src, jnp.asarray(gt)))

    want = np.asarray(recover(src))
    from rdmnet_tpu_torch.ops.geometry import apply_transform

    got = weighted_procrustes(torch.from_numpy(src),
                              apply_transform(torch.from_numpy(src), torch.from_numpy(gt))).numpy()
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], rtol=0, atol=1e-5)
    extent = float(np.abs(src).max())
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], rtol=0, atol=1e-5 * extent)
    assert contracts.rotation_error_deg(gt, got) < contracts.RRE_MAX_DEG


def test_corrupted_knn_table_fails(monkeypatch, scan):
    real = contracts.radius_knn

    def corrupted(*args, **kwargs):
        table = real(*args, **kwargs).clone()
        table[:, [0, 1]] = table[:, [1, 0]]  # the two nearest out of order
        return table

    monkeypatch.setattr(contracts, "radius_knn", corrupted)
    results = contracts.run_fast_contracts(device="cpu", scan=scan)
    assert results["knn_exact"].startswith("FAIL"), results
    assert results["sinkhorn"] == "pass" and results["horn_pose_recovery"] == "pass"


def test_contracts_refuse_without_a_card(scan):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        contracts.run_fast_contracts(scan=scan)


# ---------------------------------------------------------------- create_model, make_batch_loss

def test_create_model():
    cfg = make_tiny_cfg()
    model = create_model(cfg, device="cpu")
    assert isinstance(model, RDMNet) and model.cfg == cfg
    assert next(model.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_model(cfg)


def test_make_batch_loss_equals_value_and_grad_metrics():
    cfg = make_tiny_cfg()
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    ref = scans[0][rng.permutation(len(scans[0]))[:500], :3]
    src = scans[1][rng.permutation(len(scans[1]))[:480], :3]
    tf = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    pad = lambda p: np.concatenate([p, np.full((CAP - len(p), 3), 1e9, np.float32)])  # noqa: E731
    host = {"ref_points": np.stack([pad(ref), pad(src)]), "ref_counts": np.array([500, 480]),
            "src_points": np.stack([pad(src), pad(ref)]), "src_counts": np.array([480, 500]),
            "transform": np.stack([tf, np.linalg.inv(tf).astype(np.float32)])}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    batch = batch_to_device(host, cfg.pyramid, device="cpu")
    loss, metrics = make_batch_loss(cfg, device="cpu")(model, batch,
                                                       torch.Generator().manual_seed(5))
    state = create_train_state(cfg, model, steps_per_epoch=10)
    want, _ = make_value_and_grad(cfg, device="cpu")(state, batch, torch.Generator().manual_seed(5))
    torch.set_num_threads(threads)
    assert loss.requires_grad and torch.equal(loss.detach(), metrics["loss"].detach())
    assert set(want) == set(metrics) | {"grad_norm"}
    for name, value in metrics.items():
        assert torch.equal(value.detach(), want[name]), name
    assert float(loss.detach()) > 0


# ---------------------------------------------------------------- golden end to end

def test_golden_e2e_port():
    """The port under the parity config with the dump's converted state dict,
    on the dump's own collate graph, against the reference's outputs (the
    JAX package's ``tests/test_golden_e2e.py`` bounds)."""
    if not os.path.exists(GOLDEN):
        pytest.skip(f"golden dump absent ({GOLDEN}; scripts/dump_reference_golden.py makes it)")
    from rdmnet_tpu_torch.utils.torch_convert import convert_state_dict

    graph, outs, sd = load_golden_npz(GOLDEN)
    batch = pair_batch_from_stacked(graph["points"], graph["lengths"], graph["neighbors"],
                                    graph["subsampling"], graph["upsampling"],
                                    np.eye(4, dtype=np.float32), device="cpu")
    model = RDMNet(make_parity_cfg(), device="cpu")
    model.load_state_dict(convert_state_dict(sd), strict=True)
    with torch.no_grad():
        out = model(batch, training=False, with_gt=False)
    rel = lambda a, b: np.abs(a - b).max() / (np.abs(b).max() + 1e-6)  # noqa: E731
    ref_nf = int(graph["lengths"][1][0])
    assert rel(out["ref_feats_f"].numpy()[:ref_nf], outs["ref_feats_f"][:ref_nf]) < 1e-4
    tf, want = out["estimated_transform"].numpy(), outs["estimated_transform"]
    assert np.abs(tf[:3, :3] - want[:3, :3]).max() < 1e-4
    assert np.abs(tf[:3, 3] - want[:3, 3]).max() < 2e-3
