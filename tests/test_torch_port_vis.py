"""The port's visualization and figure utilities against the JAX package's, on
the CPU: ``utils/{visualization,html_viewer,eval_figures,baselines,common}``
and the flags behind them, ``rdmnet-torch-test --vis`` and
``rdmnet-torch-eval --figures``.

Held: each exporter writes files byte-equal to the JAX function's on the same
numpy inputs; Umeyama, ATE, recall curves and the published table give the
same numbers within 1e-12 (the same float64 numpy code); ``cli.test --vis``
writes, for every pair, the files JAX's ``_export_pair_vis`` writes from the
same dump, byte for byte; ``cli.eval --figures --baselines kitti`` writes the
file names of the JAX CLI on the same dumps, and every PNG opens (PNGs are
not compared byte for byte); ``profiler_trace`` writes a Chrome trace.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from rdmnet_tpu.utils import baselines as jbase
from rdmnet_tpu.utils import eval_figures as jfig
from rdmnet_tpu.utils import html_viewer as jhtml
from rdmnet_tpu.utils import visualization as jvis
from rdmnet_tpu_torch.data.datasets import SCHEMAS
from rdmnet_tpu_torch.data.procedural import procedural_sequence
from rdmnet_tpu_torch.utils import baselines as tbase
from rdmnet_tpu_torch.utils import eval_figures as tfig
from rdmnet_tpu_torch.utils import html_viewer as thtml
from rdmnet_tpu_torch.utils import visualization as tvis
from rdmnet_tpu_torch.utils.common import (dump_pickle, get_log_string, load_pickle,
                                           profiler_trace)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _inputs():
    rng = np.random.RandomState(0)
    pts = (rng.randn(300, 3) * 10).astype(np.float32)
    other = (rng.randn(280, 3) * 10).astype(np.float32)
    corr = rng.randint(0, 280, 40)
    return dict(pts=pts, other=other, ref_corr=pts[:40], src_corr=other[corr],
                correct=rng.rand(40) < 0.6, keep=rng.rand(300) < 0.3,
                shifted=pts + rng.randn(300, 3).astype(np.float32),
                owner=rng.randint(0, 17, 300), colors=rng.rand(300, 3))


EXPORTS = {
    "ply_points": lambda m, d, x: m.write_ply_points(os.path.join(d, "p.ply"), x["pts"]),
    "ply_points_colored": lambda m, d, x: m.write_ply_points(os.path.join(d, "p.ply"), x["pts"],
                                                             x["colors"]),
    "ply_lines": lambda m, d, x: m.write_ply_lines(os.path.join(d, "l.ply"), x["ref_corr"],
                                                   x["src_corr"], color=(0.3, 0.2, 0.9)),
    "correspondences": lambda m, d, x: m.export_correspondences(
        d, x["pts"], x["other"], x["ref_corr"], x["src_corr"]),
    "correspondences_graded": lambda m, d, x: m.export_correspondences(
        d, x["pts"], x["other"], x["ref_corr"], x["src_corr"], corr_correct=x["correct"]),
    "votes": lambda m, d, x: m.export_votes(d, x["pts"], x["shifted"], keep_mask=x["keep"],
                                            prefix="ref_"),
    "votes_unmasked": lambda m, d, x: m.export_votes(d, x["pts"], x["shifted"]),
    "grouping": lambda m, d, x: m.export_grouping(d, x["pts"], x["owner"], prefix="src_"),
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_ply_exports_byte_equal_jax(tmp_path, name):
    x = _inputs()
    EXPORTS[name](tvis, str(tmp_path / "port"), x)
    EXPORTS[name](jvis, str(tmp_path / "jax"), x)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got.keys() == want.keys() and got
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("extra", [False, True])
def test_html_viewer_byte_equal_jax(tmp_path, extra):
    x = _inputs()
    kw = dict(corr_ref=x["ref_corr"], corr_src_aligned=x["src_corr"], corr_correct=x["correct"],
              extra_layers={"ref NMS survivors": x["shifted"][x["keep"]]} if extra else None,
              title="8_1_0", max_points=200)
    got = thtml.export_pair_html(str(tmp_path / "port.html"), x["pts"], x["other"], **kw)
    want = jhtml.export_pair_html(str(tmp_path / "jax.html"), x["pts"], x["other"], **kw)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def _trajectories():
    rng = np.random.RandomState(1)
    rel = []
    for _ in range(6):
        a = rng.uniform(-0.1, 0.1)
        t = np.eye(4)
        t[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        t[:3, 3] = rng.randn(3) + [5.0, 0, 0]
        rel.append(t)
    noisy = [r + np.pad(rng.randn(3, 4) * 1e-2, ((0, 1), (0, 0))) for r in rel]
    return rel, noisy


def test_trajectory_numbers_equal_jax():
    rel, noisy = _trajectories()
    est, gt = tfig.compose_trajectory(noisy), tfig.compose_trajectory(rel)
    jest, jgt = jfig.compose_trajectory(noisy), jfig.compose_trajectory(rel)
    np.testing.assert_allclose(est, jest, rtol=0, atol=1e-12)
    errs, aligned = tfig.absolute_trajectory_error(est, gt)
    jerrs, jaligned = jfig.absolute_trajectory_error(jest, jgt)
    assert errs.keys() == jerrs.keys()
    for k in jerrs:
        assert abs(errs[k] - jerrs[k]) <= 1e-12, k
    np.testing.assert_allclose(aligned, jaligned, rtol=0, atol=1e-12)


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_equal_jax(with_scale):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 50)
    y = 1.3 * x[[1, 0, 2]] + rng.randn(3, 1) + rng.randn(3, 50) * 1e-3
    for a, b in zip(tfig.umeyama_alignment(x, y, with_scale),
                    jfig.umeyama_alignment(x, y, with_scale)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_recall_vs_threshold_equal_jax():
    rng = np.random.RandomState(3)
    rre, rte = rng.rand(100) * 8, rng.rand(100) * 3
    args = (rre, rte, np.linspace(0.25, 5, 20), np.linspace(0.1, 2, 20), 5.0, 2.0)
    for a, b in zip(tfig.recall_vs_threshold(*args), jfig.recall_vs_threshold(*args)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dataset", ["kitti", "kitti360", "apollo", "mulran", "nuscenes"])
def test_published_for_equal_jax(dataset):
    assert tbase.published_for(dataset) == jbase.published_for(dataset)
    assert bool(tbase.published_for(dataset)) == (dataset != "nuscenes")


def test_pickle_round_trip(tmp_path):
    obj = {"a": np.arange(3), "b": [1, "x"]}
    dump_pickle(obj, str(tmp_path / "d" / "o.pkl"))
    back = load_pickle(str(tmp_path / "d" / "o.pkl"))
    assert back["b"] == obj["b"] and np.array_equal(back["a"], obj["a"])


def test_get_log_string():
    assert get_log_string({"loss": 1.5, "tag": "x"}, epoch=2, iteration=7, lr=1e-4) == \
        "epoch: 2, iter: 7, loss: 1.5000, tag: x, lr: 1.000e-04"


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof is not None
    with profiler_trace(None) as nothing:
        assert nothing is None


# ------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """``cli.test --vis`` at the tiny config on a KITTI-layout root whose test
    sequence 08 holds 3 frames (2 pairs), random weights; the arguments of
    each ``_export_pair_vis`` call."""
    from rdmnet_tpu_torch.cli import test as test_cli

    tmp = tmp_path_factory.mktemp("vis")
    root = str(tmp / "root")
    schema = SCHEMAS["kitti"]
    scans, poses = procedural_sequence(21, 3, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    for i, scan in enumerate(scans):
        path = os.path.join(root, schema.cloud_path.format(seq=8, frame=i))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, scan[rng.permutation(len(scan))[:500], :3])
    lines = []
    for i in range(2):
        tf = np.linalg.inv(poses[i + 1]) @ poses[i]
        lines.append(f"{i + 1} {i} " + " ".join(f"{v:.9f}" for v in tf[:3].reshape(-1)))
    for seq in schema.test_seqs:  # 08 holds the pairs, 09 and 10 none
        gt = os.path.join(root, schema.gt_file.format(seq=seq))
        os.makedirs(os.path.dirname(gt), exist_ok=True)
        with open(gt, "w") as f:
            f.write("\n".join(lines) if seq == 8 else "")

    calls = []
    export = test_cli._export_pair_vis

    def record(*args):
        calls.append(args)
        return export(*args)

    feature_dir = str(tmp / "featureskitti")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    test_cli._export_pair_vis = record
    try:
        test_cli.main(["--root", root, "--device", "cpu", "--cfg_preset", "tiny",
                       "--feature_dir", feature_dir, "--vis"])
    finally:
        test_cli._export_pair_vis = export
        torch.set_num_threads(threads)
    return dict(feature_dir=feature_dir, calls=calls, tmp=tmp)


def test_test_vis_writes_the_jax_exports(dumps):
    from rdmnet_tpu.cli.test import _export_pair_vis as jax_export

    names = sorted(f[:-4] for f in os.listdir(dumps["feature_dir"]) if f.endswith(".npz"))
    assert names == ["8_1_0", "8_2_1"]
    assert sorted(os.listdir(os.path.join(dumps["feature_dir"], "vis"))) == names
    assert len(dumps["calls"]) == 2
    for pair_dir, dumped, vis, transform, radius in dumps["calls"]:
        assert {"vis_ref_nodes", "vis_ref_shifted", "vis_ref_keep"} <= set(vis)
        with np.load(os.path.join(dumps["feature_dir"], os.path.basename(pair_dir) + ".npz")) as d:
            assert set(d.files) == set(dumped)  # the npz keeps the reference schema
        jax_dir = str(dumps["tmp"] / "jaxvis" / os.path.basename(pair_dir))
        jax_export(jax_dir, dumped, vis, transform, radius)
        got, want = _files(pair_dir), _files(jax_dir)
        assert got.keys() == want.keys(), (sorted(got), sorted(want))
        assert {"viewer.html", "ref_points.ply", "src_grouping.ply",
                "ref_vote_offsets.ply"} <= set(got)
        for k in want:
            assert got[k] == want[k], k


@pytest.mark.parametrize("figure_dir", [None, "figs"])
def test_eval_figures_write_the_jax_file_names(dumps, tmp_path, monkeypatch, figure_dir):
    import matplotlib.image

    from rdmnet_tpu.cli import eval as jax_eval
    from rdmnet_tpu_torch.cli import eval as eval_cli

    feature_dir = dumps["feature_dir"]
    args = ["--feature_dir", feature_dir, "--figures", "--baselines", "kitti"]
    port_dir = str(tmp_path / "port") if figure_dir else os.path.join(feature_dir, "figures")
    summary = eval_cli.main(args + ["--device", "cpu"]
                            + (["--figure_dir", port_dir] if figure_dir else []))
    assert summary["n_pairs"] == 2
    got = sorted(os.listdir(port_dir))
    jax_dir = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["eval"] + args + ["--figure_dir", jax_dir])
    jax_eval.main()
    assert got == sorted(os.listdir(jax_dir)) == [
        "method_comparison_lgr.png", "recall_curves_lgr.png", "traj_seq8_lgr.png"]
    for name in got:
        img = matplotlib.image.imread(os.path.join(port_dir, name))
        assert img.ndim == 3 and min(img.shape[:2]) > 100, name


def test_eval_baselines_default_from_the_feature_dir():
    from rdmnet_tpu_torch.cli.eval import default_baselines

    assert default_baselines("output/featureskitti") == "kitti"
    assert default_baselines("/x/featureskitti360/") == "kitti360"
    assert default_baselines("out/MulRan_dump") == "mulran"
    assert default_baselines("output/run") is None
