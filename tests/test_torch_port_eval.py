"""The port's evaluation path against the JAX package's, on the CPU at
``make_tiny_cfg()``: ``utils/metrics_np.py``, ``cli/test.py::run_eval_loop``
(dumps, board, bucket dispatch, shards, the vote-off setting) and
``cli/eval.py`` (its ``--json_out`` for every method, the skipped pair,
device RANSAC, teaser).

Weights are the port's draw of seed 12 carried to the JAX side with
``params_to_jax``; the JAX side searches exactly (``approx_recall=None``).
The test split holds two pairs, each a procedural scan against a rigidly
moved copy of itself: 500 points (bucket 1.0, caps 512/256/128/128/128) and
240 points (bucket 0.5, caps 256/128/128/128/128). These weights register
both at their buckets, so their correspondences determine the pose (see
``test_torch_port_model.py``). Tolerances: every point and index array of a
dump exact; the coarse nodes (the vote layer's output), scores, features,
overlaps and ``corr_scores`` 1e-4 (float32 sums in another order); the pose 1e-4; board means 1e-4; the metric
functions 1e-6; the eval CLI's JSON 1e-9 (both sides run the same numpy). The
port runs on one thread.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import re
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from rdmnet_tpu.cli import eval as jeval
from rdmnet_tpu.cli import test as jtest
from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.data.datasets import RegistrationPairDataset as JaxDataset
from rdmnet_tpu.models import RDMNet as JaxRDMNet
from rdmnet_tpu.utils import metrics_np as jmetrics
from rdmnet_tpu_torch.cli import eval as teval
from rdmnet_tpu_torch.cli import test as ttest
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.datasets import SCHEMAS, RegistrationPairDataset
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.engine import create_train_state
from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.utils import metrics_np
from rdmnet_tpu_torch.utils.convert import params_to_jax

SCALES = (0.5, 1.0)
MOTION = np.eye(4, dtype=np.float32)
MOTION[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
MOTION[:3, 3] = [0.5, 0.3, 0.1]
EXACT = ("ref_points", "src_points", "ref_points_f", "src_points_f", "ref_node_corr_indices",
         "src_node_corr_indices", "gt_node_corr_indices", "transform", "ref_corr_points",
         "src_corr_points")
# the coarse nodes are the vote layer's shifted positions: an MLP's output
CLOSE = ("ref_points_c", "src_points_c", "ref_feats_c", "src_feats_c", "gt_node_corr_overlaps",
         "corr_scores", "estimated_transform")


# ------------------------------------------------------------------ metrics

def _rotation(rng):
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _metric_args(name, rng):
    tf = np.eye(4)
    tf[:3, :3], tf[:3, 3] = _rotation(rng), rng.randn(3)
    tf2 = np.eye(4)
    tf2[:3, :3], tf2[:3, 3] = _rotation(rng) @ tf[:3, :3], tf[:3, 3] + 0.1 * rng.randn(3)
    a, b = rng.rand(300, 3) * 5, rng.rand(280, 3) * 5
    pairs = np.stack([rng.randint(0, 30, 40), rng.randint(0, 25, 40)], 1)
    gt = np.unique(np.stack([rng.randint(0, 30, 60), rng.randint(0, 25, 60)], 1), axis=0)
    return {
        "compute_relative_rotation_error": (tf[:3, :3], tf2[:3, :3]),
        "rotation_to_euler_xyz_degrees": (tf[:3, :3],),
        "compute_relative_rotation_error_rpy": (tf[:3, :3], tf2[:3, :3]),
        "compute_registration_error": (tf, tf2),
        "compute_inlier_ratio": (a[:200], b[:200], tf, 1.5),
        "compute_overlap": (a, b, tf, 0.8),
        "compute_correspondence_residual": (a[:200], b[:200], tf),
        "evaluate_correspondences": (a[:200], b[:200], tf, 2.0),
        "compute_rotation_mse_and_mae": (tf[:3, :3], tf2[:3, :3]),
        "compute_translation_mse_and_mae": (tf[:3, 3], tf2[:3, 3]),
        "compute_transform_mse_and_mae": (tf, tf2),
        "modified_chamfer_distance": (a, a[:150], b[:120], tf, tf2),
        "evaluate_sparse_correspondences": (30, 25, pairs[:, 0], pairs[:, 1], gt),
        "compute_relative_translation_error": (tf[:3, 3], tf2[:3, 3]),
        "compute_registration_rmse": (b, tf, tf2),
        "get_correspondences": (a, b, tf, 0.5),
        "evaluate_overlap": (rng.rand(30), rng.rand(25), a, b, a[:30], b[:25], np.eye(4), 0.3),
        "evaluate_node_overlap": (30, 25, gt[:20, 0], gt[:20, 1], gt, rng.rand(len(gt))),
    }[name]


METRICS = [n for n in dir(jmetrics) if not n.startswith("_") and callable(getattr(jmetrics, n))
           and getattr(jmetrics, n).__module__ == jmetrics.__name__]


@pytest.mark.parametrize("name", METRICS)
def test_metric_function_matches_jax(name):
    assert hasattr(metrics_np, name)
    for seed in range(3):
        args = _metric_args(name, np.random.RandomState(seed))
        got, want = getattr(metrics_np, name)(*args), getattr(jmetrics, name)(*args)
        if isinstance(want, dict):
            assert set(got) == set(want)
            got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_metrics_module_is_complete():
    assert len(METRICS) == 18
    assert set(METRICS) <= set(dir(metrics_np))


# -------------------------------------------------------------- eval loop

def _write_seq(root, seq, clouds, transform):
    schema = SCHEMAS["kitti"]
    for i, cloud in enumerate(clouds):
        path = os.path.join(root, schema.cloud_path.format(seq=seq, frame=i))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, cloud)
    path = os.path.join(root, schema.gt_file.format(seq=seq))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if transform is not None:
            f.write("1 0 " + " ".join(f"{v:.9f}" for v in transform[:3].reshape(-1)))


def _jax_cfg(vote=True):
    cfg = jax_tiny_cfg()
    return cfg.replace(pyramid=dataclasses.replace(cfg.pyramid, approx_recall=None),
                       vote=dataclasses.replace(cfg.vote, inference_use_vote=vote))


def _cfg(vote=True):
    cfg = make_tiny_cfg()
    return dataclasses.replace(cfg, vote=dataclasses.replace(cfg.vote, inference_use_vote=vote))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    small, _, _ = procedural_pair(7353, n_rings=16, n_azimuths=200)
    perm = np.random.RandomState(0).permutation(len(small))
    for seq, n in ((8, 500), (9, 240)):
        ref = small[perm[:n]]
        _write_seq(root, seq, [ref, ((ref - MOTION[:3, 3]) @ MOTION[:3, :3]).astype(np.float32)],
                   MOTION)
    _write_seq(root, 10, [], None)
    return root


@pytest.fixture(scope="module")
def weights():
    model = RDMNet(make_tiny_cfg(), device="cpu", generator=torch.Generator().manual_seed(12))
    return model, jax.tree.map(np.asarray, params_to_jax(model))


def _run_both(root, out, weights, vote=True, scales=SCALES, shards=2):
    """Both packages' ``run_eval_loop`` over the test split, shard by shard,
    into ``out/jax`` and ``out/port``. Returns per side the boards' summaries
    by shard and the log lines."""
    model, params = weights
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    res = {}
    for side in ("jax", "port"):
        feature_dir = os.path.join(out, side)
        os.makedirs(feature_dir, exist_ok=True)
        logs, boards = [], []
        if side == "jax":
            cfgs = [_jax_cfg(vote).replace(pyramid=_jax_cfg(vote).pyramid.scaled(s))
                    for s in scales]
            ds = JaxDataset("kitti", root, "test")
            jmodel = JaxRDMNet(cfgs[-1])
            run = lambda idx: jtest.run_eval_loop(  # noqa: E731
                cfgs[-1], jmodel, params, ds, idx, feature_dir, log=logs.append,
                cfgs=cfgs if len(cfgs) > 1 else None)
        else:
            cfgs = [dataclasses.replace(_cfg(vote), pyramid=_cfg(vote).pyramid.scaled(s))
                    for s in scales]
            ds = RegistrationPairDataset("kitti", root, "test")
            tmodel = RDMNet(cfgs[-1], device="cpu")
            tmodel.load_state_dict(model.state_dict())
            run = lambda idx: ttest.run_eval_loop(  # noqa: E731
                cfgs[-1], tmodel, ds, idx, feature_dir, log=logs.append,
                cfgs=cfgs if len(cfgs) > 1 else None, device="cpu")
        for shard in range(shards):
            boards.append(run(list(range(shard, len(ds), shards))).summary())
        res[side] = dict(dir=feature_dir, boards=boards, logs=logs)
    torch.set_num_threads(threads)
    return res


@pytest.fixture(scope="module")
def loops(root, weights, tmp_path_factory):
    return _run_both(root, str(tmp_path_factory.mktemp("loops")), weights)


def _names(d):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "*.npz")))


def _assert_dumps_equal(got_dir, want_dir, registering=True):
    assert _names(got_dir) == _names(want_dir) and _names(want_dir)
    for name in _names(want_dir):
        got, want = np.load(os.path.join(got_dir, name)), np.load(os.path.join(want_dir, name))
        assert set(got.files) == set(want.files), name
        for key in EXACT:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        for key in CLOSE:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {key}")
        if registering:
            np.testing.assert_allclose(want["estimated_transform"], MOTION, atol=0.05,
                                       err_msg=name)


def test_eval_loop_dumps_match_jax(loops):
    _assert_dumps_equal(loops["port"]["dir"], loops["jax"]["dir"])
    assert _names(loops["port"]["dir"]) == ["8_1_0.npz", "9_1_0.npz"]


def test_eval_loop_boards_match_jax(loops):
    for got, want in zip(loops["port"]["boards"], loops["jax"]["boards"]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)
        assert want["RR"] == 1.0


def test_eval_loop_bucket_dispatch_and_shards_match_jax(loops):
    def caps(logs):
        return sorted(re.search(r"\] (\S+) \|", line).group(1) + re.search(r"cap (\d+)", line)
                      .group(1) for line in logs)

    assert caps(loops["port"]["logs"]) == caps(loops["jax"]["logs"]) == ["8_1_0512", "9_1_0256"]
    assert [line.split("]")[0] for line in loops["port"]["logs"]] == ["[1/1", "[1/1"]


def test_eval_loop_without_vote_matches_jax(root, weights, tmp_path):
    """The MulRan setting: matching on the unshifted nodes and the first
    transformer's features."""
    res = _run_both(root, str(tmp_path), weights, vote=False, scales=(1.0,), shards=1)
    _assert_dumps_equal(res["port"]["dir"], res["jax"]["dir"], registering=False)
    want = res["jax"]["boards"][0]
    for key, value in want.items():
        # these weights do not register this pair without the vote: its pose
        # rests on a few ill-conditioned correspondences, so RRE/RTE are held
        # only when it registers
        if key in ("RRE", "RTE") and want["RR"] < 1.0:
            continue
        np.testing.assert_allclose(res["port"]["boards"][0][key], value, atol=1e-4, err_msg=key)


def test_test_cli_on_a_snapshot(root, weights, loops, tmp_path, capsys):
    """``rdmnet-torch-test`` on a port snapshot of the same weights writes the
    loop's dumps (uncompressed with --no_compress)."""
    model, _ = weights
    cfg = make_tiny_cfg()
    mgr = CheckpointManager(str(tmp_path / "snap"))
    mgr.save(3, create_train_state(cfg, model), metadata={"epoch": 3})
    mgr.close()
    out = str(tmp_path / "dumps")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    board = ttest.main(["--root", root, "--snapshot_dir", str(tmp_path / "snap"), "--device",
                        "cpu", "--cfg_preset", "tiny", "--buckets", "0.5,1.0", "--feature_dir",
                        out, "--no_compress"])
    torch.set_num_threads(threads)
    assert "== summary ==" in capsys.readouterr().out
    assert board.mean("RR") == 1.0
    for name in _names(loops["port"]["dir"]):
        got, want = np.load(os.path.join(out, name)), np.load(os.path.join(loops["port"]["dir"],
                                                                            name))
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    assert os.path.getsize(os.path.join(out, "8_1_0.npz")) > os.path.getsize(
        os.path.join(loops["port"]["dir"], "8_1_0.npz"))


def test_export_and_infer_read_a_snapshot(weights, tmp_path, capsys):
    """``rdmnet-torch-export`` and ``rdmnet-torch-infer`` take the snapshot's
    weights (the JAX CLIs' ``--snapshot_dir``/``--test_epoch``)."""
    from rdmnet_tpu_torch.cli import export, infer
    from rdmnet_tpu_torch.utils.convert import flatten_params

    model, _ = weights
    mgr = CheckpointManager(str(tmp_path / "snap"))
    mgr.save(5, create_train_state(make_tiny_cfg(), model), metadata={"epoch": 5})
    mgr.close()
    small, _, _ = procedural_pair(7353, n_rings=16, n_azimuths=200)
    assets = tmp_path / "pc"
    assets.mkdir()
    for frame in (0, 4, 7):
        np.save(assets / f"{frame:06d}.npy", small[:300])
    snap = ["--snapshot_dir", str(tmp_path / "snap"), "--test_epoch", "5"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    export.main(["--device", "cpu", "--cfg_preset", "tiny", "--out_dir", str(tmp_path / "art"),
                 *snap])
    infer.main(["--device", "cpu", "--cfg_preset", "tiny", "--asset_dir", str(assets),
                "--output_dir", str(tmp_path / "infer"), "--ransac_iterations", "0", *snap])
    torch.set_num_threads(threads)
    saved = np.load(tmp_path / "art" / "weights.npz")
    for i, arr in enumerate(flatten_params(model)):
        np.testing.assert_array_equal(saved[f"w{i}"], arr)
    # the same scan as ref and src: these weights give the identity
    out = np.load(tmp_path / "infer" / "0_4_0.npz")
    np.testing.assert_allclose(out["estimated_transform"], np.eye(4), atol=1e-4)
    assert "exported" in capsys.readouterr().out


def test_test_cli_defaults_to_cuda(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttest.main(["--root", root, "--cfg_preset", "tiny", "--feature_dir", str(tmp_path)])


# ------------------------------------------------------------------ eval CLI

@pytest.fixture(scope="module")
def eval_dir(loops, tmp_path_factory):
    """The JAX loop's dumps, plus a copy under the name the reference skips."""
    d = str(tmp_path_factory.mktemp("eval"))
    for name in _names(loops["jax"]["dir"]):
        shutil.copy(os.path.join(loops["jax"]["dir"], name), d)
    shutil.copy(os.path.join(d, "9_1_0.npz"), os.path.join(d, "8_15_14.npz"))
    return d


def _jax_eval(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["rdmnet-eval"] + argv)
    jeval.main()


def _assert_json_close(got, want, path=""):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-9, (path, got, want)
    else:
        assert got == want, path


@pytest.mark.parametrize("method", ["lgr", "svd", "ransac", "ransac_featurematch"])
def test_eval_cli_json_matches_jax(eval_dir, tmp_path, monkeypatch, method):
    argv = ["--feature_dir", eval_dir, "--method", method, "--ransac_impl", "numpy",
            "--ransac_iterations", "300"]
    _jax_eval(argv + ["--json_out", str(tmp_path / "jax.json")], monkeypatch)
    summary = teval.main(argv + ["--json_out", str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    _assert_json_close(got, want)
    assert summary == got
    assert got["n_pairs"] == 2  # 8_15_14 skipped
    assert [p["src_frame"] for p in got["per_pair"]] == [1, 1]
    if method == "lgr":
        assert got["RR"] == 1.0 and got["failed_pairs"] == []


def test_device_ransac_matches_jax(eval_dir):
    d = np.load(os.path.join(eval_dir, "8_1_0.npz"))
    args = (d["src_corr_points"], d["ref_corr_points"], d["corr_scores"])
    got = teval.ransac_device(*args, num_iterations=4000, device="cpu")
    want = jeval.ransac_device(*args, num_iterations=4000)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, MOTION, atol=0.05)


def test_eval_cli_device_ransac_and_teaser(eval_dir, tmp_path):
    summary = teval.main(["--feature_dir", eval_dir, "--method", "ransac", "--device", "cpu",
                          "--ransac_iterations", "4000", "--json_out", str(tmp_path / "d.json")])
    assert summary["n_pairs"] == 2 and summary["RR"] == 1.0
    with open(tmp_path / "d.json") as f:
        assert set(json.load(f)) == {"method", "n_pairs", "RR", "RRE_deg", "RTE_m", "PIR", "IR",
                                     "overlap", "failed_pairs", "per_pair"}
    if importlib.util.find_spec("teaserpp_python") is None:
        with pytest.raises(ImportError, match="teaserpp"):
            teval.main(["--feature_dir", eval_dir, "--method", "teaser"])
