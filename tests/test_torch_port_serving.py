"""The port's serving slice against the JAX package's, on the CPU, at
``make_tiny_cfg()``: padding, the ``weights.npz`` layout, loading a JAX
artifact, ``serve`` against the JAX live forward, bucket dispatch, the HTTP
protocol, ``trim_outputs`` and ``make_cli_cfg``.

Weights are a flax init carried across with ``params_from_jax``. The JAX
side searches exactly (``approx_recall=None``), as the port always does.
Tolerances: correspondence points and every index exact; scores, features
and ``corr_scores`` 1e-4 (float32, other summation orders); the pose 1e-4 on
a scan against a rigidly moved copy of itself (the pair whose
correspondences determine the pose, see ``test_torch_port_model.py``). The
port runs on one thread: multithreaded CPU sums jitter enough to flip an NMS
or top-k decision.
"""

import argparse
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu import serving as jserving
from rdmnet_tpu.cli import common as jcommon
from rdmnet_tpu.cli import serve as jserve
from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
from rdmnet_tpu.data import loader as jloader
from rdmnet_tpu.data.procedural import procedural_sequence
from rdmnet_tpu.graph.pyramid import build_pair_batch as jax_build_pair_batch
from rdmnet_tpu.models import RDMNet as JaxRDMNet
from rdmnet_tpu_torch import serving
from rdmnet_tpu_torch.cli import common, serve
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.loader import pad_points_np
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.utils.convert import flat_leaf_paths, load_flat_params, params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
SCALES = (0.5, 1.0)
ANGLE, SHIFT = 0.05, np.array([0.5, 0.3, 0.1], np.float32)
MOTION = np.eye(4, dtype=np.float32)
MOTION[:2, :2] = [[np.cos(ANGLE), -np.sin(ANGLE)], [np.sin(ANGLE), np.cos(ANGLE)]]
MOTION[:3, 3] = SHIFT


def _jax_cfg(scale=1.0):
    cfg = jax_tiny_cfg()
    pyr = cfg.pyramid if scale == 1.0 else cfg.pyramid.scaled(scale)
    return dataclasses.replace(cfg, pyramid=dataclasses.replace(pyr, approx_recall=None))


def _scan():
    scans, _ = procedural_sequence(11, 1, n_rings=16, n_azimuths=200)
    return scans[0][np.random.RandomState(0).permutation(len(scans[0]))[:500], :3]


def _moved(ref):
    return ((ref - SHIFT) @ MOTION[:3, :3]).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX params, the port's model holding them, its artifact (buckets 0.5
    and 1.0) and the ``serve`` loaded from it on the CPU."""
    jcfg = _jax_cfg()
    jmodel = JaxRDMNet(jcfg)
    ref = _scan()
    rp, rc, sp, sc = jcommon.pad_pair_np(jcfg, ref, ref)
    params = jax.jit(lambda *a: jmodel.init(
        jax.random.PRNGKey(0), jax_build_pair_batch(*a, jnp.eye(4), jcfg.pyramid),
        training=False, with_gt=False))(rp, rc, sp, sc)
    params = jax.tree.map(np.asarray, params)
    model = RDMNet(make_tiny_cfg(), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    out_dir = str(tmp_path_factory.mktemp("artifact"))
    buckets = serving.export_inference(make_tiny_cfg(), model, out_dir, bucket_scales=SCALES)
    fn, meta = serving.load_exported(out_dir, device="cpu")
    return dict(params=params, model=model, out_dir=out_dir, buckets=buckets, serve=fn,
                meta=meta, ref=ref)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ padding

@pytest.mark.parametrize("n", [0, 100, 512, 700])
def test_padding_matches_jax(n):
    pts = np.random.RandomState(n).rand(n, 4).astype(np.float32) * 30
    for got, want in [(pad_points_np(pts[:, :3], 512), jloader.pad_points_np(pts[:, :3], 512)),
                      (serving._pad_np(pts, 512), jserving._pad_np(pts, 512))]:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == min(n, 512) and got[1].dtype == want[1].dtype
    assert serving.PAD_COORD == jserving.PAD_COORD
    assert serving.SERVE_OUTPUTS == jserving.SERVE_OUTPUTS


# ------------------------------------------------------------ weights layout

def test_flat_leaf_order_is_tree_flatten_order():
    names = ["layers_10", "layers_2", "mlp_0", "mlp_norm_0", "self_0", "cross_0", "out_norm",
             "Dense_0", "alpha", "a_b", "a"]
    rng = np.random.RandomState(0)
    tree = {"params": {n: {m: {"kernel": rng.rand(2), "bias": rng.rand(1), "scale": rng.rand(3)}
                           for m in names[:4]} for n in names}}
    leaves, _ = jax.tree_util.tree_flatten(tree)
    ours = []
    for path in flat_leaf_paths(tree):
        node = tree
        for part in path:
            node = node[part]
        ours.append(node)
    assert len(ours) == len(leaves)
    assert all(a is b for a, b in zip(ours, leaves))


def test_weights_npz_is_the_jax_layout(setup):
    flat, _ = jax.tree_util.tree_flatten(setup["params"])
    assert set(setup["params"]) == {"params"}  # no collection besides params
    got = np.load(f"{setup['out_dir']}/weights.npz")
    assert sorted(got.files) == sorted(f"w{i}" for i in range(len(flat)))
    assert setup["meta"]["n_weights"] == len(flat)
    for i, want in enumerate(flat):
        assert got[f"w{i}"].dtype == want.dtype == np.float32
        assert got[f"w{i}"].shape == want.shape, f"w{i}"
        np.testing.assert_array_equal(got[f"w{i}"], want, err_msg=f"w{i}")


def test_serving_json_keeps_the_jax_keys(setup):
    meta = json.load(open(f"{setup['out_dir']}/serving.json"))
    caps = [jax_tiny_cfg().pyramid.scaled(0.5).caps[0], jax_tiny_cfg().pyramid.caps[0]]
    assert meta["cap"] == caps[-1]
    assert [b["cap"] for b in meta["buckets"]] == caps
    assert [b["scale"] for b in meta["buckets"]] == list(SCALES)
    assert meta["outputs"] == list(jserving.SERVE_OUTPUTS)
    assert meta["pad_coord"] == jserving.PAD_COORD
    assert meta["config"]["pyramid"]["caps"] == list(make_tiny_cfg().pyramid.caps)


def _write_jax_artifact(params, out_dir, scales):
    """What the JAX package's export writes beside its StableHLO: the
    tree_flatten leaves and a serving.json without config or scales."""
    flat, _ = jax.tree_util.tree_flatten(params)
    np.savez(f"{out_dir}/weights.npz", **{f"w{i}": np.asarray(x) for i, x in enumerate(flat)})
    pyr = jax_tiny_cfg().pyramid
    caps = sorted({(pyr if s == 1.0 else pyr.scaled(s)).caps[0] for s in scales})
    meta = {"cap": caps[-1], "buckets": [{"cap": c, "file": f"model_b{c}.stablehlo"} for c in caps],
            "n_weights": len(flat), "outputs": list(jserving.SERVE_OUTPUTS),
            "platforms": ["cpu"], "pad_coord": jserving.PAD_COORD}
    with open(f"{out_dir}/serving.json", "w") as f:
        json.dump(meta, f)
    return flat


def test_jax_layout_loads_strict_and_serves(setup, tmp_path, one_thread):
    flat = _write_jax_artifact(setup["params"], tmp_path, SCALES)
    want = params_from_jax(setup["params"])
    model = RDMNet(make_tiny_cfg(), device="cpu", generator=torch.Generator().manual_seed(5))
    load_flat_params(model, flat)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    with pytest.raises(ValueError, match="no config"):
        serving.load_exported(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="differ from the artifact"):
        serving.load_exported(str(tmp_path), device="cpu", cfg=make_tiny_cfg(),
                              bucket_scales=(0.7, 1.0))
    fn, _ = serving.load_exported(str(tmp_path), device="cpu", cfg=make_tiny_cfg(),
                                  bucket_scales=SCALES)
    loaded = fn.model.state_dict()
    for k in want:
        assert torch.equal(loaded[k], want[k]), k
    ref = setup["ref"]
    a, b = fn(ref, _moved(ref)), setup["serve"](ref, _moved(ref))
    for k in serving.SERVE_OUTPUTS:
        np.testing.assert_array_equal(a[k], b[k])

    with pytest.raises(ValueError, match="weight arrays"):
        load_flat_params(model, flat[:-1])


def test_load_exported_needs_a_card_unless_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_exported(setup["out_dir"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_exported(setup["out_dir"], device="cuda")
    fn, _ = serving.load_exported(setup["out_dir"], device="cpu")
    assert fn.model.device.type == "cpu"


# ------------------------------------------------------------ serve vs JAX

@pytest.mark.parametrize("scale,n", [(1.0, 500), (0.5, 200)])
def test_serve_matches_jax_live_forward(setup, one_thread, scale, n):
    """Both buckets, each on a pair that fits it. Rows whose score is 0 are
    padding that consumers drop (``corr_scores > 0``): their points are
    whatever the masked patches held, so only the valid rows are compared."""
    ref = setup["ref"][:n]
    src = _moved(ref)
    out = setup["serve"](ref, src)
    jcfg = _jax_cfg(scale)
    assert setup["serve"].last_cap == jcfg.pyramid.caps[0]
    forward = jcommon.make_forward(jcfg, JaxRDMNet(jcfg), with_gt=False)
    live = jax.tree.map(np.asarray, forward(setup["params"], *jcommon.pad_pair_np(jcfg, ref, src),
                                            np.eye(4, dtype=np.float32)))
    valid = live["corr_scores"] > 0
    np.testing.assert_array_equal(out["corr_scores"] > 0, valid)
    assert valid.sum() > 10
    for k in ("ref_corr_points", "src_corr_points"):
        assert out[k].shape == live[k].shape
        np.testing.assert_array_equal(out[k][valid], live[k][valid], err_msg=k)
    np.testing.assert_allclose(out["corr_scores"], live["corr_scores"], **TOL)
    np.testing.assert_allclose(out["estimated_transform"], live["estimated_transform"], **TOL)
    np.testing.assert_allclose(out["estimated_transform"], MOTION, atol=0.05)


def test_bucket_dispatch(setup):
    jpyr = jax_tiny_cfg().pyramid
    scales = (1.0, 0.5, 0.7, 0.5)  # unsorted, with a duplicate
    caps = [b["cap"] for b in serving.bucket_configs(make_tiny_cfg(), scales)]
    assert caps == [jpyr.scaled(0.5).caps[0], jpyr.scaled(0.7).caps[0], jpyr.caps[0]]
    for b in serving.bucket_configs(make_tiny_cfg(), scales):
        want = jpyr if b["scale"] == 1.0 else jpyr.scaled(b["scale"])
        for f in dataclasses.fields(b["cfg"].pyramid):
            assert getattr(b["cfg"].pyramid, f.name) == getattr(want, f.name), f.name

    fn, small, big = setup["serve"], 256, 512
    rng = np.random.RandomState(3)
    for n, cap in [(small - 10, small), (small, small), (small + 10, big), (big + 64, big)]:
        pts = (rng.rand(n, 3) * 20).astype(np.float32)
        out = fn(pts, pts)
        assert fn.last_cap == cap, n
        assert out["estimated_transform"].shape == (4, 4)
        assert np.isfinite(out["estimated_transform"]).all()
    # beyond every bucket: the largest serves the first cap points
    huge = (rng.rand(big + 64, 3) * 20).astype(np.float32)
    a, b = fn(huge, huge), fn(huge[:big], huge[:big])
    for k in serving.SERVE_OUTPUTS:
        np.testing.assert_array_equal(a[k], b[k])


def test_buckets_share_one_set_of_weights(setup):
    fn = setup["serve"]
    ptrs = {p.data_ptr() for p in fn.model.parameters()}
    pts = (np.random.RandomState(4).rand(100, 3) * 20).astype(np.float32)
    fn(pts, pts)
    from rdmnet_tpu_torch.models import with_pyramid

    view = with_pyramid(fn.model, serving.bucket_configs(make_tiny_cfg(), SCALES)[0]["cfg"].pyramid)
    assert {p.data_ptr() for p in view.parameters()} == ptrs
    assert view.cfg.pyramid.caps[0] == 256 and fn.model.cfg.pyramid.caps[0] == 512


# ------------------------------------------------------------ HTTP protocol

def _faulty(fn):
    """``fn`` that fails as a device fault would on a one-point cloud."""
    def call(ref, src):
        if len(ref) == 1:
            raise RuntimeError("device fault")
        out = fn(ref, src)
        call.last_cap = fn.last_cap
        return out
    call.last_cap = None
    return call


def _drive(handler_factory, serve_fn, meta, requests):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler_factory(serve_fn, meta))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results = []
    try:
        for method, path, body in requests:
            req = urllib.request.Request(url + path, data=body, method=method)
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    code, data = r.status, r.read()
            except urllib.error.HTTPError as e:
                code, data = e.code, e.read()
            if code == 200 and path == "/register":
                data = dict(np.load(io.BytesIO(data)))
            elif code == 200:
                data = json.loads(data)
            results.append((code, data))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return results


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_http_protocol_matches_jax(setup, one_thread):
    ref = setup["ref"]
    rng = np.random.RandomState(5)
    small = (rng.rand(200, 3) * 20).astype(np.float32)
    requests = [
        ("GET", "/healthz", None),
        ("POST", "/register", _npz(ref_points=ref, src_points=_moved(ref))),
        ("POST", "/register", _npz(ref_points=small, src_points=small)),
        ("POST", "/register", b"not an npz"),
        ("POST", "/register", _npz(ref_points=small)),
        ("POST", "/register", _npz(ref_points=small[:1], src_points=small[:1])),
        ("GET", "/nope", None),
        ("POST", "/nope", b""),
        ("GET", "/healthz", None),
    ]
    got = _drive(serve.make_handler, _faulty(setup["serve"]), setup["meta"], requests)
    want = _drive(jserve.make_handler, _faulty(setup["serve"]), setup["meta"], requests)
    assert [c for c, _ in got] == [c for c, _ in want] == [200, 200, 200, 400, 400, 500, 404,
                                                          404, 200]
    for (_, a), (_, b) in zip(got, want):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
        else:
            assert a == b
    health = got[-1][1]
    assert health["requests"] == 2 and health["errors"] == 3
    assert health["bucket_requests"] == {"512": 1, "256": 1}
    direct = setup["serve"](ref, _moved(ref))
    sel = direct["corr_scores"] > 0
    np.testing.assert_allclose(got[1][1]["estimated_transform"], direct["estimated_transform"],
                               atol=1e-6)
    assert len(got[1][1]["corr_scores"]) == int(sel.sum())


# ------------------------------------------------------------ CLI helpers

@pytest.fixture(scope="module")
def gt_outputs(setup):
    """JAX and port forward outputs with ground truth on the moved pair."""
    ref = setup["ref"]
    src = _moved(ref)
    jcfg = _jax_cfg()
    padded = jcommon.pad_pair_np(jcfg, ref, src)
    jout = jax.tree.map(np.asarray, jcommon.make_forward(jcfg, JaxRDMNet(jcfg), with_gt=True)(
        setup["params"], *padded, MOTION))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tout = common.make_forward(make_tiny_cfg(), setup["model"], with_gt=True, device="cpu")(
        *common.pad_pair_np(make_tiny_cfg(), ref, src), MOTION)
    torch.set_num_threads(threads)
    return jout, tout


@pytest.mark.parametrize("vis", [False, True])
def test_trim_outputs_matches_jax(gt_outputs, vis):
    jout, tout = gt_outputs
    got = common.trim_outputs(jout, MOTION, vis=vis)
    want = jcommon.trim_outputs(jout, MOTION, vis=vis)
    assert got.keys() == want.keys()
    assert "gt_node_corr_indices" in got and len(got["gt_node_corr_indices"]) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's own forward, trimmed from torch tensors
    mine = common.trim_outputs(tout, MOTION, vis=vis)
    assert mine.keys() == want.keys()
    for k in want:
        if want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(mine[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("argv", [
    [],
    ["--cfg_preset", "tiny"],
    ["--caps", "30000,12288,5120,2048,1024", "--neighbor_limits", "35,36,37,38,39"],
    ["--cfg_preset", "tiny", "--band_caps", "384,none,-,none,none", "--caps",
     "640,256,128,64,32"],
])
def test_make_cli_cfg_matches_jax(argv):
    cfgs = []
    for mod in (common, jcommon):
        parser = argparse.ArgumentParser()
        mod.add_pyramid_overrides(parser)
        cfgs.append(mod.make_cli_cfg(parser.parse_args(argv)))
    tc, jc = cfgs
    for field in dataclasses.fields(tc):
        tsub, jsub = getattr(tc, field.name), getattr(jc, field.name)
        if not dataclasses.is_dataclass(tsub):  # seed, compute_dtype
            assert tsub == jsub, field.name
            continue
        for f in dataclasses.fields(tsub):
            assert getattr(tsub, f.name) == getattr(jsub, f.name), (field.name, f.name)
    # the same buckets from the overridden config
    for s in (0.5, 0.7):
        assert tc.pyramid.scaled(s).caps == jc.pyramid.scaled(s).caps
        assert tc.pyramid.scaled(s).band_caps == jc.pyramid.scaled(s).band_caps


def test_make_cli_cfg_rejects_wrong_cap_count():
    for mod in (common, jcommon):
        parser = argparse.ArgumentParser()
        mod.add_pyramid_overrides(parser)
        with pytest.raises(ValueError, match="per-level values"):
            mod.make_cli_cfg(parser.parse_args(["--caps", "100,50"]))


def test_config_round_trips_through_serving_json():
    from rdmnet_tpu_torch.config import Config, config_from_dict, make_cfg

    for cfg in (make_cfg(), make_tiny_cfg()):
        assert config_from_dict(Config, json.loads(json.dumps(dataclasses.asdict(cfg)))) == cfg


def test_export_check_and_serve_cli(setup, tmp_path, monkeypatch, capsys, one_thread):
    """``rdmnet-torch-export --check`` on procedural demo clouds, then
    ``rdmnet-torch-serve`` on the port's artifact and on a JAX-layout one,
    up to the point where it would serve forever."""
    from rdmnet_tpu_torch.cli import export

    assets = tmp_path / "pc"
    assets.mkdir()
    scans, _ = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    for frame, scan in zip((0, 4), scans):
        np.save(assets / f"{frame:06d}.npy", scan[:300])
    art = str(tmp_path / "artifact")
    export.main(["--device", "cpu", "--cfg_preset", "tiny", "--out_dir", art, "--buckets",
                 "0.5,1.0", "--check", "--asset_dir", str(assets)])
    printed = capsys.readouterr().out
    assert "caps=256,512" in printed and "check: OK" in printed

    bound = []

    class Server(ThreadingHTTPServer):
        def serve_forever(self, poll_interval=0.5):
            bound.append(self.server_address)
            self.server_close()

    monkeypatch.setattr(serve, "ThreadingHTTPServer", Server)
    serve.main(["--device", "cpu", "--artifact_dir", art, "--port", "0", "--warmup"])
    for extra in (["--caps", "1,2,3,4,5"], ["--cfg_preset", "tiny"]):
        with pytest.raises(SystemExit):  # only a JAX artifact (--buckets) reads them
            serve.main(["--device", "cpu", "--artifact_dir", art, "--port", "0", *extra])
    captured = capsys.readouterr()
    assert "apply only with --buckets" in captured.err
    jax_art = tmp_path / "jax_artifact"
    jax_art.mkdir()
    _write_jax_artifact(setup["params"], jax_art, SCALES)
    with pytest.raises(ValueError, match="no config"):
        serve.main(["--device", "cpu", "--artifact_dir", str(jax_art), "--port", "0"])
    serve.main(["--device", "cpu", "--cfg_preset", "tiny", "--buckets", "0.5,1.0",
                "--artifact_dir", str(jax_art), "--port", "0", "--warmup"])
    assert len(bound) == 2
    assert (captured.out + capsys.readouterr().out).count("serving ") == 2
