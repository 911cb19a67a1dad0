"""The port's model-surface CLIs on the CPU, at ``make_tiny_cfg()``:

* ``rdmnet-torch-convert``: a synthetic upstream ``.pth.tar`` imported into
  a snapshot and exported back through its own schema, exactly;
* ``--torch_checkpoint`` / ``--parity_cfg`` / ``--no_parity_cfg`` /
  ``--coarse_module``: the config they select equals the JAX CLIs'
  (``make_cli_cfg``); ``rdmnet-torch-test``, ``-infer`` and ``-export`` with
  ``--torch_checkpoint`` load the converted weights (dumps equal to a run on
  the converted snapshot; the infer pose equal to ``pipeline`` on the
  original weights; ``weights.npz`` equal to the model's);
* serving a GeoTransformer model: an artifact in the JAX package's layout
  with the config passed in, responses equal to the JAX live forward
  (the tolerances of ``test_torch_port_serving.py``), and the port's own
  artifact rebuilding the family from its ``serving.json``;
* ``rdmnet-torch-test-sweep``: two worker processes dump every test pair of
  a procedural KITTI root once, and eval runs per method; a sweep whose
  workers die raises before eval (twin of ``tests/test_sweep_cli.py``);
* every CLI module imports and has ``main``, and each ``rdmnet-torch-*``
  console script names one.
"""

import argparse
import dataclasses
import glob
import importlib
import json
import os
import os.path as osp
import re

import jax
import numpy as np
import pytest
import torch

from rdmnet_tpu.cli import common as jcommon
from rdmnet_tpu.models import RDMNet as JaxRDMNet
from rdmnet_tpu_torch import serving
from rdmnet_tpu_torch.cli import common
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.datasets import write_procedural_root
from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager
from rdmnet_tpu_torch.engine.train_step import create_train_state
from rdmnet_tpu_torch.graph.pyramid import pad_cloud
from rdmnet_tpu_torch.models import RDMNet, pipeline
from rdmnet_tpu_torch.utils.convert import flatten_params, params_to_jax
from rdmnet_tpu_torch.utils.torch_convert import export_state_dict, load_torch_checkpoint
from test_torch_port_convert import family_schema
from test_torch_port_serving import _write_jax_artifact
from test_torch_port_variants import MOTION, jax_twin, moved_pair, VARIANTS

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """A tiny model's weights as an upstream ``.pth.tar`` (epoch 7), and a
    procedural KITTI root whose test split has two pairs."""
    tmp = tmp_path_factory.mktemp("upstream")
    model = RDMNet(make_tiny_cfg(), device="cpu", generator=torch.Generator().manual_seed(3))
    schema, _ = family_schema(model)
    blob = str(tmp / "rdmnet.pth.tar")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          export_state_dict(model.state_dict(), schema).items()}, "epoch": 7},
               blob)
    root = str(tmp / "kitti")
    write_procedural_root(root, "kitti", {8: (3, 3)}, n_rings=16, n_azimuths=200)
    return dict(model=model, blob=blob, root=root, tmp=tmp)


# ------------------------------------------------------------ convert

def test_convert_import_then_export_round_trips(upstream):
    from rdmnet_tpu_torch.cli import convert

    snaps = str(upstream["tmp"] / "converted")
    assert convert.main(["--cfg_preset", "tiny", "--torch_checkpoint", upstream["blob"],
                         "--output_dir", snaps]) == 7
    mgr = CheckpointManager(snaps)
    assert mgr.all_steps() == [7]
    assert mgr.read_metadata()["requires_parity_cfg"] is True
    restored = mgr.restore_params()
    original = upstream["model"].state_dict()
    assert set(restored) == set(original)
    assert all(torch.equal(restored[k], original[k]) for k in original)

    out = str(upstream["tmp"] / "back.pth.tar")
    assert convert.main(["--cfg_preset", "tiny", "--snapshot_dir", snaps, "--to_torch", out,
                         "--schema", upstream["blob"]]) == 7
    back, want = load_torch_checkpoint(out), load_torch_checkpoint(upstream["blob"])
    assert set(back) == set(want)
    for k in want:
        assert back[k].dtype == want[k].dtype
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert torch.load(out, weights_only=True)["epoch"] == 7
    with pytest.raises(SystemExit):
        convert.main(["--to_torch", out])  # export needs --snapshot_dir and --schema


# ------------------------------------------------------------ config flags

def _args(**kw):
    base = dict(torch_checkpoint=None, no_parity_cfg=False, parity_cfg=False, coarse_module=None,
                cfg_preset=None, caps=None, neighbor_limits=None, band_caps=None, platform=None)
    return argparse.Namespace(**dict(base, **kw))


@pytest.mark.parametrize("flags", [
    dict(torch_checkpoint="w.pth.tar"),
    dict(torch_checkpoint="w.pth.tar", no_parity_cfg=True),
    dict(parity_cfg=True, coarse_module="geotransformer"),
    dict(coarse_module="ape", neighbor_limits="30,31,32,33,34"),
    dict(cfg_preset="tiny", torch_checkpoint="w.pth.tar"),
])
def test_make_cli_cfg_picks_the_jax_config(flags):
    tc, jc = common.make_cli_cfg(_args(**flags)), jcommon.make_cli_cfg(_args(**flags))
    for field in dataclasses.fields(tc):
        tsub, jsub = getattr(tc, field.name), getattr(jc, field.name)
        if not dataclasses.is_dataclass(tsub):
            assert tsub == jsub
            continue
        for f in dataclasses.fields(tsub):
            assert getattr(tsub, f.name) == getattr(jsub, f.name), (field.name, f.name)
    parity = flags.get("parity_cfg") or (flags.get("torch_checkpoint")
                                         and not flags.get("no_parity_cfg"))
    assert common.uses_parity_cfg(_args(**flags)) == bool(parity)
    if parity and not flags.get("cfg_preset"):
        assert tc.pyramid.neighbor_limits == (65, 63, 69, 71, 81)


def test_test_infer_export_load_the_upstream_checkpoint(upstream, tmp_path, one_thread):
    from rdmnet_tpu_torch.cli import convert, export, infer, test

    base = ["--device", "cpu", "--cfg_preset", "tiny"]
    snaps = str(tmp_path / "snaps")
    convert.main(["--cfg_preset", "tiny", "--torch_checkpoint", upstream["blob"],
                  "--output_dir", snaps])
    dumps = {}
    for name, weights in (("ckpt", ["--torch_checkpoint", upstream["blob"]]),
                          ("snap", ["--snapshot_dir", snaps])):
        feat = str(tmp_path / name)
        test.main(base + ["--root", upstream["root"], "--feature_dir", feat, "--no_compress"]
                  + weights)
        dumps[name] = {osp.basename(p): dict(np.load(p)) for p in glob.glob(f"{feat}/*.npz")}
    assert len(dumps["ckpt"]) == 2 and set(dumps["ckpt"]) == set(dumps["snap"])
    for name, got in dumps["ckpt"].items():
        for k, v in dumps["snap"][name].items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")

    assets = tmp_path / "pc"
    assets.mkdir()
    ref, src = moved_pair(300)
    for frame, scan in zip((0, 4, 7), (ref, src, src)):
        np.save(assets / f"{frame:06d}.npy", scan)
    out_dir = str(tmp_path / "infer")
    infer.main(base + ["--asset_dir", str(assets), "--output_dir", out_dir,
                       "--ransac_iterations", "0", "--torch_checkpoint", upstream["blob"]])
    got = np.load(glob.glob(f"{out_dir}/*_4_0.npz")[0])["estimated_transform"]
    want = pipeline(upstream["model"], *pad_cloud(ref, 512), *pad_cloud(src, 512),
                    device="cpu")["estimated_transform"].numpy()
    np.testing.assert_array_equal(got, want)

    art = str(tmp_path / "artifact")
    export.main(base + ["--out_dir", art, "--torch_checkpoint", upstream["blob"]])
    weights = np.load(f"{art}/weights.npz")
    for i, want in enumerate(flatten_params(upstream["model"])):
        np.testing.assert_array_equal(weights[f"w{i}"], want)


# ------------------------------------------------------------ serving a family

def test_geotransformer_artifacts_serve_like_jax(tmp_path, one_thread):
    jcfg, tcfg = jax_twin(VARIANTS["geotransformer"])
    model = RDMNet(tcfg, device="cpu", generator=torch.Generator().manual_seed(2))
    params = params_to_jax(model)
    _write_jax_artifact(params, tmp_path, (1.0,))
    cfg = common.make_cli_cfg(_args(cfg_preset="tiny", coarse_module="geotransformer"))
    assert cfg == tcfg
    fn, _ = serving.load_exported(str(tmp_path), device="cpu", cfg=cfg, bucket_scales=(1.0,))
    assert "transformer2.embedding.proj_a.weight" in fn.model.state_dict()

    ref, src = moved_pair()
    out = fn(ref, src)
    forward = jcommon.make_forward(jcfg, JaxRDMNet(jcfg), with_gt=False)
    live = jax.tree.map(np.asarray, forward(params, *jcommon.pad_pair_np(jcfg, ref, src),
                                            np.eye(4, dtype=np.float32)))
    valid = live["corr_scores"] > 0
    np.testing.assert_array_equal(out["corr_scores"] > 0, valid)
    assert valid.sum() > 10
    for k in ("ref_corr_points", "src_corr_points"):
        np.testing.assert_array_equal(out[k][valid], live[k][valid], err_msg=k)
    np.testing.assert_allclose(out["corr_scores"], live["corr_scores"], **TOL)
    np.testing.assert_allclose(out["estimated_transform"], live["estimated_transform"], **TOL)
    np.testing.assert_allclose(out["estimated_transform"], MOTION, atol=0.05)

    # the port's own artifact names its family: no config needed to rebuild it
    own = str(tmp_path / "own")
    serving.export_inference(tcfg, model, own)
    with open(f"{own}/serving.json") as f:
        assert json.load(f)["config"]["model"]["coarse_module"] == "geotransformer"
    fn2, _ = serving.load_exported(own, device="cpu")
    assert fn2.model.cfg == tcfg
    np.testing.assert_array_equal(fn2(ref, src)["estimated_transform"], out["estimated_transform"])


# ------------------------------------------------------------ snapshot sweep

@pytest.fixture(scope="module")
def snapshots(upstream):
    cfg = make_tiny_cfg()
    snap_dir = str(upstream["tmp"] / "sweep_snaps")
    mgr = CheckpointManager(snap_dir)
    for epoch in (1, 2):
        mgr.save(epoch, create_train_state(cfg, RDMNet(
            cfg, device="cpu", generator=torch.Generator().manual_seed(epoch))))
    mgr.close()
    return snap_dir


def _sweep(upstream, snap_dir, feature_root, epochs=("1",), methods=("lgr", "svd")):
    from rdmnet_tpu_torch.cli import test_sweep

    cwd = os.getcwd()
    os.chdir(REPO)  # workers run ``python -m rdmnet_tpu_torch...`` from here
    try:
        return test_sweep.main(
            ["--root", upstream["root"], "--snapshot_dir", snap_dir, "--epochs", *epochs,
             "--methods", *methods, "--feature_root", feature_root, "--num_workers", "2",
             "--worker_env", "CUDA_VISIBLE_DEVICES={shard}", "OMP_NUM_THREADS=1",
             "--worker_args", "--device cpu --cfg_preset tiny --no_compress",
             "--eval_args", "--device cpu"])
    finally:
        os.chdir(cwd)


def test_sweep_two_workers_dump_and_evaluate_every_pair(upstream, snapshots, tmp_path, capfd):
    dirs = _sweep(upstream, snapshots, str(tmp_path / "sweep"), epochs=("1", "2"),
                  methods=("lgr",))
    out = capfd.readouterr().out
    assert [osp.basename(d) for d in dirs] == ["kitti_epoch1", "kitti_epoch2"]
    for d in dirs:
        names = sorted(osp.basename(p) for p in glob.glob(f"{d}/*.npz"))
        assert names == ["8_1_0.npz", "8_2_1.npz"]  # both pairs, each once
    assert len(re.findall(r"== eval \(lgr\) over 2 pairs ==", out)) == 2
    # the two epochs' weights differ, so their dumps do
    a, b = (np.load(f"{d}/8_1_0.npz")["ref_feats_c"] for d in dirs)
    assert a.shape != b.shape or not np.array_equal(a, b)


def test_sweep_raises_when_a_worker_dies(upstream, snapshots, tmp_path, capfd):
    with pytest.raises(RuntimeError, match=r"test worker\(s\) failed"):
        _sweep(upstream, snapshots + "_missing", str(tmp_path / "sweep"))
    assert "== eval" not in capfd.readouterr().out


# ------------------------------------------------------------ CLI modules

CLIS = ("trainval", "test", "eval", "export", "serve", "infer", "convert", "test_sweep",
        "preprocess")


@pytest.mark.parametrize("name", CLIS)
def test_cli_module_imports_with_main(name):
    assert callable(importlib.import_module(f"rdmnet_tpu_torch.cli.{name}").main)


def test_console_scripts_name_cli_mains():
    with open(osp.join(REPO, "pyproject.toml")) as f:
        scripts = dict(re.findall(r'^(rdmnet-torch-[\w-]+) = "([\w.]+):main"$', f.read(), re.M))
    assert scripts["rdmnet-torch-convert"] == "rdmnet_tpu_torch.cli.convert"
    assert scripts["rdmnet-torch-test-sweep"] == "rdmnet_tpu_torch.cli.test_sweep"
    assert scripts["rdmnet-torch-preprocess"] == "rdmnet_tpu_torch.cli.preprocess"
    assert sorted(m.rsplit(".", 1)[1] for m in scripts.values()) == sorted(CLIS)
