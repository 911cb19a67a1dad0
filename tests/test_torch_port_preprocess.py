"""The data-preparation workflow of the PyTorch port against the JAX package,
on the CPU: the native graph builder, downsampling, the readers, ICP, pair
generation, calibration, the transforms and the preprocess CLI.

Tolerances:
* the native builder (subsample, kNN tables, whole pyramids), voxel
  downsampling, the readers, the calibrated limits, band caps and raw
  neighbour counts, the transforms: equal (the same library source built
  with the same flags on this host; numpy on both sides);
* the native builder against the port's device builder: as
  ``tests/test_native.py`` holds the JAX package's (centroids within 1e-5,
  kNN rows with equal distance sets, pyramid neighbour sets > 99% equal);
* CPU ICP: within 1e-9 of the JAX package's transform (the same search and
  numpy arithmetic; BLAS may round the last bit otherwise);
* pair files: the same pairs, each of the 12 printed values within 2e-6 (one
  unit of the sixth decimal, where a value lies on a rounding boundary).

Calibration is held against the JAX package's with its grid ops compiled
(``jax.jit``), the rounding its pyramid build runs with. The JAX module calls
them eagerly, where ``x / cell`` divides instead of multiplying by the
float32 reciprocal as compiled XLA does, so its calibration measures voxel
grids its own runtime never builds; the port measures its runtime's grids
(``test_jax_eager_calibration_departs_from_its_runtime`` pins the
difference).

The card's ICP and calibration are held against these CPU paths in
``test_torch_port_cuda.py`` and ``chip_smoke.py`` (phase 13).
"""

import os
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

import rdmnet_tpu.ops  # noqa: F401  (loads rdmnet_tpu.ops.grid_subsample)
import tests.test_preprocess as jtp
from rdmnet_tpu.cli import preprocess as jcli
from rdmnet_tpu.config import PyramidConfig as JaxPyramidConfig
from rdmnet_tpu.data import calibration as jcal
from rdmnet_tpu.data import preprocess as jpre
from rdmnet_tpu.data import transforms as jtr
from rdmnet_tpu.graph import native as jnative
from rdmnet_tpu.utils.se3_np import apply_transform, euler_zyx_matrix
from rdmnet_tpu_torch.cli import preprocess as tcli
from rdmnet_tpu_torch.config import PyramidConfig
from rdmnet_tpu_torch.data import calibration as tcal
from rdmnet_tpu_torch.data.datasets import write_procedural_root
from rdmnet_tpu_torch.data import preprocess as tpre
from rdmnet_tpu_torch.data import procedural as tproc
from rdmnet_tpu_torch.data import transforms as ttr
from rdmnet_tpu_torch.graph import native as tnative
from rdmnet_tpu_torch.graph.pyramid import build_cloud_pyramid, pad_cloud
from rdmnet_tpu_torch.ops.grid_subsample import grid_subsample, voxel_sort_key_np
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.ops.radius_search import radius_knn

SPEC = dict(num_stages=3, voxel_size=0.5, search_radius=1.0, caps=(256, 128, 64),
            neighbor_limits=(12, 12, 12))
# calibration: five levels over ~2-3k-point procedural scans
CAL_SPEC = dict(caps=(4096, 2048, 1024, 512, 256), neighbor_limits=(40,) * 5)


@pytest.fixture
def rng():
    return np.random.RandomState(7351)


JAX_GRID = sys.modules["rdmnet_tpu.ops.grid_subsample"]  # the package exports a function of that name


@pytest.fixture
def jax_compiled_grid_ops(monkeypatch):
    """The JAX calibration module with its grid ops compiled, as the JAX
    pyramid build runs them."""
    monkeypatch.setattr(jcal, "grid_subsample",
                        jax.jit(JAX_GRID.grid_subsample, static_argnums=(2, 3)))
    monkeypatch.setattr(JAX_GRID, "voxel_sort_key",
                        jax.jit(JAX_GRID.voxel_sort_key, static_argnums=(2,)))


def _scans(n=2, seed=31):
    scans, _ = tproc.procedural_sequence(seed, n, n_rings=16, n_azimuths=200)
    return [s[:, :3] for s in scans]


# ------------------------------------------------------------ native builder

def test_native_library_built_by_the_port():
    lib = tnative._load()
    assert tnative.available()
    assert osp.dirname(lib._name) == str(tnative.BUILD_DIR)
    assert osp.basename(lib._name).startswith("librdmnet_native-")
    assert tnative.SOURCE == tnative.REPO_DIR / "native" / "graph_builder.cpp"
    assert osp.realpath(lib._name) != osp.realpath(jnative._LIB_PATH)
    assert osp.realpath(lib._name) == osp.realpath(tnative.library_path())
    # the flags of native/Makefile, with the compiler its CXX defaults to
    make_flags = (tnative.REPO_DIR / "native" / "Makefile").read_text()
    assert " ".join(tnative.CXX[1:-1]) in make_flags and tnative.CXX[0] == "g++"


def test_native_grid_subsample_and_knn_equal_jax(rng):
    pts = (rng.rand(3000, 3) * 20).astype(np.float32)
    for voxel, cap in ((0.6, 2500), (1.3, 400)):
        a, na = tnative.grid_subsample_native(pts, voxel, cap)
        b, nb = jnative.grid_subsample_native(pts, voxel, cap)
        assert na == nb
        np.testing.assert_array_equal(a, b)
    q = (rng.rand(1000, 3) * 20).astype(np.float32)
    for radius, k, count in ((1.0, 16, 3000), (0.5, 1, 2500)):
        np.testing.assert_array_equal(tnative.radius_knn_native(q, pts, count, radius, k),
                                      jnative.radius_knn_native(q, pts, count, radius, k))


def test_native_pyramid_equals_jax(rng):
    pts = (rng.rand(180, 3) * 6).astype(np.float32)
    a = tnative.build_pyramid_native(pts, PyramidConfig(**SPEC))
    b = jnative.build_pyramid_native(pts, JaxPyramidConfig(**SPEC))
    assert a["counts"] == b["counts"]
    for field in ("points", "neighbors", "subsampling", "upsampling"):
        for x, y in zip(a[field], b[field]):
            np.testing.assert_array_equal(x, y, err_msg=field)


def test_voxel_sort_key_np_equals_jax(rng):
    from rdmnet_tpu.ops.grid_subsample import voxel_sort_key_np as jax_key

    pts = (rng.rand(2000, 3) * 50 - 25).astype(np.float32)
    for cell in (0.6, 1.2, 2.4):
        np.testing.assert_array_equal(voxel_sort_key_np(pts, cell), jax_key(pts, cell))


def test_native_matches_device_builder(rng):
    """As ``tests/test_native.py`` holds the JAX package's native builder
    against its device ops."""
    pts = (rng.rand(200, 3) * 8).astype(np.float32)
    nat, n_nat = tnative.grid_subsample_native(pts, 1.0, 160)
    padded = np.pad(pts, ((0, 56), (0, 0)), constant_values=1e9)
    dev, n_dev, _ = grid_subsample(torch.from_numpy(padded)[None], torch.tensor([200]), 1.0, 160)
    assert n_nat == int(n_dev[0])
    np.testing.assert_allclose(nat[:n_nat], dev[0, :n_nat].numpy(), atol=1e-5)

    s = (rng.rand(100, 3) * 4).astype(np.float32)
    q = (rng.rand(40, 3) * 4).astype(np.float32)
    nat = tnative.radius_knn_native(q, s, 100, 1.0, 8)
    dev = radius_knn(torch.from_numpy(q), torch.from_numpy(s), torch.tensor(100), 1.0, 8).numpy()
    d = ((q[:, None] - s[None]) ** 2).sum(-1)
    for i in range(40):
        a, b = nat[i][nat[i] < 100], dev[i][dev[i] < 100]
        assert len(a) == len(b)
        np.testing.assert_allclose(d[i][a], d[i][b], atol=1e-5)

    spec = PyramidConfig(**SPEC, band_caps=(None, None, None))
    pts = (rng.rand(180, 3) * 6).astype(np.float32)
    nat = tnative.build_pyramid_native(pts, spec)
    rp, rc = pad_cloud(pts, 256)
    dev = build_cloud_pyramid(rp[None], rc.reshape(1), spec)
    for lvl in range(3):
        n = nat["counts"][lvl]
        assert n == int(dev.counts[lvl][0])
        np.testing.assert_allclose(nat["points"][lvl][:n], dev.points[lvl][0, :n].numpy(),
                                   atol=1e-4)
        a, b = nat["neighbors"][lvl][:n], dev.neighbors[lvl][0, :n].numpy()
        assert (np.sort(a, 1) == np.sort(b, 1)).mean() > 0.99


# ------------------------------------------------------------ preprocess

def test_voxel_downsample_same_bytes(rng):
    pts = (rng.rand(5000, 4) * 10).astype(np.float32)
    for voxel in (0.3, 1.0):
        a, b = tpre.voxel_downsample_xyzi(pts, voxel), jpre.voxel_downsample_xyzi(pts, voxel)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tproc.voxel_downsample_xyzi is tpre.voxel_downsample_xyzi


@pytest.mark.parametrize("init", [False, True])
def test_icp_cpu_equals_jax(rng, init):
    pts = (rng.rand(3000, 3) * 20 - 10).astype(np.float32)
    tf = np.eye(4)
    tf[:3, :3] = euler_zyx_matrix(0.02, -0.01, 0.015)
    tf[:3, 3] = [0.1, -0.15, 0.05]
    moved = apply_transform(pts, np.linalg.inv(tf)).astype(np.float32)
    start = np.eye(4)
    start[:3, 3] = [0.05, 0.0, 0.0]
    kw = {"init": start} if init else {}
    before = launch_counts()
    got = tpre.icp_point_to_point(moved, pts, max_correspondence_distance=0.5, device="cpu", **kw)
    assert launch_counts() == before  # the CPU search is the native library's
    want = jpre.icp_point_to_point(moved, pts, max_correspondence_distance=0.5, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    err = np.linalg.norm(apply_transform(moved, got) - pts, axis=1)
    assert np.median(err) < 0.02


def test_icp_search_reranks_the_graph_build_distance():
    """The radius-kNN search measures ``|q|^2 - 2 q.s + |s|^2`` in float32 (the
    graph build's rounding; here its plain version, which the kernel equals
    bit for bit), off by ~1e-3 m^2 some 70 m from the origin, so its own
    nearest point is sometimes farther than the native library's. ICP's
    ``nearest_within`` re-ranks the kernel's candidates on exact distances:
    no row picks a farther point than the native search."""
    scan = tproc.procedural_sequence(5, 1, n_rings=32, n_azimuths=600)[0][0][:, :3]
    ref = (scan + np.array([60.0, 35.0, 0.0], np.float32)).astype(np.float32)
    cur = ref + np.random.RandomState(0).randn(*ref.shape) * 0.05
    native = tnative.radius_knn_native(cur, ref, len(ref), 0.5, 1)[:, 0]
    d2 = lambda idx: ((cur.astype(np.float32).astype(np.float64)  # noqa: E731
                       - ref.astype(np.float64)[np.minimum(idx, len(ref) - 1)]) ** 2).sum(1)
    both = lambda idx: (idx < len(ref)) & (native < len(ref))  # noqa: E731
    k1 = radius_knn(torch.from_numpy(cur.astype(np.float32)), torch.from_numpy(ref),
                    torch.tensor(len(ref)), 0.5, 1)[:, 0].numpy()
    farther = both(k1) & (d2(k1) > d2(native) * (1 + 1e-6))
    assert farther.sum() >= 10  # the graph build's rounding misranks far points
    extent = float(np.linalg.norm(cur, axis=1).max())
    got = tpre.nearest_within(torch.from_numpy(cur), torch.from_numpy(ref), 0.5, extent).numpy()
    assert not (both(got) & (d2(got) > d2(native) * (1 + 1e-6))).any()
    assert (got != native).sum() <= 2  # float32 ties and the radius boundary only


def test_icp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    pts = np.zeros((20, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.icp_point_to_point(pts, pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.generate_pairs_for_sequence("/nonexistent", 0)


def test_readers_equal_jax(tmp_path, rng):
    velo2cam = _random_tf(rng)
    root = jtp.TestPairGeneration()._make_kitti(tmp_path, rng, velo2cam=velo2cam)
    p = osp.join(root, "poses", "00.txt")
    np.testing.assert_array_equal(tpre.read_kitti_poses(p), jpre.read_kitti_poses(p))
    c = osp.join(root, "sequences", "00", "calib.txt")
    np.testing.assert_array_equal(tpre.read_velo2cam(c), jpre.read_velo2cam(c))
    cam = tmp_path / "calib_cam_to_velo.txt"
    np.savetxt(cam, velo2cam[:3].reshape(1, -1))
    np.testing.assert_array_equal(tpre.read_cam_to_velo(cam), jpre.read_cam_to_velo(cam))
    rows = np.array([np.concatenate([[i + 3], (velo2cam * (i + 1)).reshape(-1)])
                     for i in range(4)])
    k360 = tmp_path / "cam0_to_world.txt"
    np.savetxt(k360, rows)
    for a, b in zip(tpre.read_kitti360_cam0_poses(k360), jpre.read_kitti360_cam0_poses(k360)):
        np.testing.assert_array_equal(a, b)
    ta, ja = tpre.DatasetAdapter("kitti", root), jpre.DatasetAdapter("kitti", root)
    assert ta.frame_ids(0) == ja.frame_ids(0) and ta.scan_paths(0) == ja.scan_paths(0)
    for a, b in zip(ta.poses_and_calib(0), ja.poses_and_calib(0)):
        assert (a is None and b is None) or np.array_equal(a, b)


def _random_tf(rng):
    from tests.test_ops_core import random_transform

    return np.asarray(random_transform(rng, max_angle=0.8, max_trans=1.0), np.float64)


def _same_lines(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        g, w = g.split(), w.split()
        assert g[:2] == w[:2]
        np.testing.assert_allclose(np.float64(g[2:]), np.float64(w[2:]), rtol=0, atol=2e-6)


def _kitti_root(tmp_path, rng):
    return jtp.TestPairGeneration()._make_kitti(tmp_path, rng, velo2cam=_random_tf(rng))


def _kitti360_root(tmp_path, rng):
    gen = jtp.TestPairGeneration
    root = tmp_path / "k360"
    drive = "2013_05_28_drive_0000_sync"
    scan_dir = root / "data_3d_raw" / drive / "velodyne_points" / "data"
    scan_dir.mkdir(parents=True)
    (root / "data_poses" / drive).mkdir(parents=True)
    (root / "calibration").mkdir(parents=True)
    cam_to_velo = _random_tf(rng)
    np.savetxt(root / "calibration" / "calib_cam_to_velo.txt", cam_to_velo[:3].reshape(1, -1))
    poses = gen._straight_poses(10, 4.0)
    base = (rng.rand(8000, 3) * 40 - 20).astype(np.float32)
    gen._write_scans(scan_dir, [(scan_dir / f"{i:010d}.bin", poses[i]) for i in range(10)],
                     base, np.linalg.inv(cam_to_velo))
    rows = [np.concatenate([[i], poses[i].reshape(-1)]) for i in range(2, 10)]  # sparse poses
    np.savetxt(root / "data_poses" / drive / "cam0_to_world.txt", np.array(rows))
    return str(root), 0


def _apollo_root(tmp_path, rng):
    gen = jtp.TestPairGeneration
    root = tmp_path / "apollo"
    base_dir = root / "kitti_format" / "MapData" / "ColumbiaPark" / "2018-09-21" / "01"
    (base_dir / "velodyne").mkdir(parents=True)
    poses = gen._straight_poses(8, 4.0)
    np.savetxt(base_dir / "poses.txt", np.array([p[:3].reshape(-1) for p in poses]))
    base = (rng.rand(8000, 3) * 40 - 20).astype(np.float32)
    gen._write_scans(base_dir / "velodyne",
                     [(base_dir / "velodyne" / f"{i:06d}.bin", poses[i]) for i in range(8)],
                     base, np.eye(4))
    return str(root), 1


def _mulran_root(tmp_path, rng):
    gen = jtp.TestPairGeneration
    root = tmp_path / "mulran"
    sdir = root / "kaist01" / "sensor_data" / "Ouster"
    sdir.mkdir(parents=True)
    stamps = [1561000000000 + 100_000_000 * i for i in range(8)]
    poses = gen._straight_poses(8, 4.0)
    np.savetxt(root / "kaist01" / "sensor_data" / "poses_in_kitti_format.txt",
               np.array([p[:3].reshape(-1) for p in poses]))
    base = (rng.rand(8000, 3) * 40 - 20).astype(np.float32)
    gen._write_scans(sdir, [(sdir / f"{stamps[i]:d}.bin", poses[i]) for i in range(8)],
                     base, np.eye(4))
    return str(root), "kaist01"


@pytest.mark.parametrize("dataset", ["kitti", "kitti360", "apollo", "mulran"])
def test_generate_pairs_equal_jax(tmp_path, rng, dataset):
    if dataset == "kitti":
        root, seq = _kitti_root(tmp_path, rng), 0  # non-identity Tr
    else:
        root, seq = {"kitti360": _kitti360_root, "apollo": _apollo_root,
                     "mulran": _mulran_root}[dataset](tmp_path, rng)
    got = tpre.generate_pairs_for_sequence(root, seq, thres=10.0, dataset=dataset,
                                           out_root=str(tmp_path / "port"), device="cpu")
    want = jpre.generate_pairs_for_sequence(root, seq, thres=10.0, dataset=dataset,
                                            out_root=str(tmp_path / "jax"))
    _same_lines(got, want)
    name = os.listdir(tmp_path / "jax" / "icp10")
    assert os.listdir(tmp_path / "port" / "icp10") == name
    port_file = (tmp_path / "port" / "icp10" / name[0]).read_text().splitlines()
    _same_lines(port_file, (tmp_path / "jax" / "icp10" / name[0]).read_text().splitlines())


def test_cli_downsample_and_pairs_equal_jax(tmp_path, rng, monkeypatch):
    root = _kitti_root(tmp_path, rng)
    done = tcli.main(["downsample", "--root", root, "--seqs", "0", "--out_root",
                      str(tmp_path / "port")])
    assert done == {0: 8}
    n = jpre.downsample_dataset_sequence("kitti", root, 0, 0.3, str(tmp_path / "jax"))
    assert n == 8
    for i in range(8):
        rel = osp.join("downsampled_xyzi", "00", f"{i:06d}.npy")
        assert (np.load(tmp_path / "port" / rel).tobytes()
                == np.load(tmp_path / "jax" / rel).tobytes())
    assert tcli.main(["pairs", "--root", root, "--seqs", "0", "--out_root", str(tmp_path / "port"),
                      "--device", "cpu"]) == {0: 2}
    monkeypatch.setattr(sys, "argv", ["preprocess", "pairs", "--root", root, "--seqs", "0",
                                      "--out_root", str(tmp_path / "jax")])
    jcli.main()
    _same_lines((tmp_path / "port" / "icp10" / "00").read_text().splitlines(),
                (tmp_path / "jax" / "icp10" / "00").read_text().splitlines())


# ------------------------------------------------------------ calibration

def test_neighbor_counts_equal_jax():
    import jax.numpy as jnp

    jax_grid_subsample = jax.jit(JAX_GRID.grid_subsample, static_argnums=(2, 3))
    spec = PyramidConfig(**CAL_SPEC)
    for cloud in _scans():
        n = len(cloud)
        pts = np.full((spec.caps[0], 3), 1e9, np.float32)
        pts[:n] = cloud
        jp, jc = jnp.asarray(pts), jnp.int32(n)
        tp, tc = torch.from_numpy(pts)[None], torch.tensor([n], dtype=torch.int32)
        voxel, radius = spec.voxel_size, spec.search_radius
        for lvl in range(spec.num_stages):
            if lvl > 0:
                voxel *= 2
                jp, jc = jax_grid_subsample(jp, jc, voxel, spec.caps[lvl])
                tp, tc, _ = grid_subsample(tp, tc, voxel, spec.caps[lvl])
            want = jcal._neighbor_counts(jp, jc, radius)
            np.testing.assert_array_equal(tcal._neighbor_counts(tp[0], int(tc[0]), radius), want,
                                          err_msg=f"level {lvl}")
            radius *= 2


def test_calibrate_neighbor_limits_equal_jax(jax_compiled_grid_ops):
    clouds = _scans(3)
    for threshold in (100, 10 ** 9):
        got = tcal.calibrate_neighbor_limits(clouds, PyramidConfig(**CAL_SPEC),
                                             sample_threshold=threshold, device="cpu")
        want = jcal.calibrate_neighbor_limits(clouds, JaxPyramidConfig(**CAL_SPEC),
                                              sample_threshold=threshold)
        assert got == want


def test_calibrate_band_caps_equal_jax(jax_compiled_grid_ops):
    clouds = _scans(3)
    for headroom in (1.0, 1.35):
        got = tcal.calibrate_band_caps(clouds, PyramidConfig(**CAL_SPEC), headroom=headroom,
                                       multiple=64, device="cpu")
        want = jcal.calibrate_band_caps(clouds, JaxPyramidConfig(**CAL_SPEC), headroom=headroom,
                                        multiple=64)
        assert got == want
        assert got[0] is not None


def test_jax_eager_calibration_departs_from_its_runtime(monkeypatch):
    clouds, spec = _scans(3), JaxPyramidConfig(**CAL_SPEC)
    eager = jcal.calibrate_band_caps(clouds, spec, headroom=1.0, multiple=64)
    port = tcal.calibrate_band_caps(clouds, PyramidConfig(**CAL_SPEC), headroom=1.0, multiple=64,
                                    device="cpu")
    monkeypatch.setattr(jcal, "grid_subsample",
                        jax.jit(JAX_GRID.grid_subsample, static_argnums=(2, 3)))
    compiled = jcal.calibrate_band_caps(clouds, spec, headroom=1.0, multiple=64)
    assert port == compiled == (896, 768, 640, 384, 192)
    assert eager == (896, 832, 640, 384, 192)  # level 1 subsampled on other voxel keys


@pytest.mark.parametrize("keep_ratio", [0.5, 0.8, 0.95, 1.0])
def test_limit_from_counts_equals_jax(keep_ratio):
    rng = np.random.RandomState(int(keep_ratio * 100))
    for counts in (rng.randint(0, 60, 1000), rng.poisson(25, 777), np.array([3, 3, 3, 7])):
        assert tcal.limit_from_counts(counts, keep_ratio) == jcal.limit_from_counts(counts,
                                                                                    keep_ratio)


def test_cli_calibrate_prints_jax_limits(tmp_path, capsys, monkeypatch, jax_compiled_grid_ops):
    root = str(tmp_path / "kitti")
    write_procedural_root(root, "kitti", {0: (31, 4)}, n_rings=16, n_azimuths=200)
    got = tcli.main(["calibrate", "--root", root, "--num_scans", "2", "--device", "cpu"])
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["preprocess", "calibrate", "--root", root,
                                      "--num_scans", "2"])
    jcli.main()
    jax_out = capsys.readouterr().out.splitlines()
    assert got["clouds"] == 2
    assert port_out[0] == jax_out[0] and port_out[1] == jax_out[1]  # limits, band caps
    assert port_out[3] == jax_out[3]  # the flags
    assert "rdmnet-torch-trainval" in port_out[2] and "rdmnet-torch-export" in port_out[2]
    assert port_out[0] == f"neighbor_limits = {got['neighbor_limits']}"


# ------------------------------------------------------------ transforms

def _transform_cases():
    cloud = (np.random.RandomState(0).rand(200, 3) * 10.0 - 5.0)
    normals = cloud / np.linalg.norm(cloud, axis=1, keepdims=True)
    feats = np.random.RandomState(1).rand(200, 8).astype(np.float32)
    return {
        "normalize_points": lambda T, rng: T.normalize_points(cloud),
        "sample_points": lambda T, rng: T.sample_points(cloud, 50, normals=normals),
        "random_sample_points": lambda T, rng: (T.random_sample_points(cloud[:7], 20, rng=rng),
                                                T.random_sample_points(cloud, 50, normals,
                                                                       rng=rng)),
        "random_scale_shift_points": lambda T, rng: T.random_scale_shift_points(
            cloud, normals=normals, rng=rng),
        "random_rotate_points_along_up_axis": lambda T, rng:
            T.random_rotate_points_along_up_axis(cloud, normals, rng=rng),
        "random_rescale_points": lambda T, rng: T.random_rescale_points(cloud, rng=rng),
        "random_jitter_points": lambda T, rng: T.random_jitter_points(cloud, 0.1, rng=rng),
        "random_shuffle_points": lambda T, rng: T.random_shuffle_points(cloud, normals, rng=rng),
        "random_dropout_points": lambda T, rng: T.random_dropout_points(cloud, 0.9, rng=rng),
        "random_jitter_features": lambda T, rng: [T.random_jitter_features(feats, rng=rng)
                                                  for _ in range(30)],
        "random_sample_plane": lambda T, rng: T.random_sample_plane(rng=rng),
        "random_crop_point_cloud_with_plane": lambda T, rng: (
            T.random_crop_point_cloud_with_plane(cloud, rng=rng),
            T.random_crop_point_cloud_with_plane(cloud, keep_ratio=0.4, normals=normals,
                                                 rng=rng)),
        "random_sample_viewpoint": lambda T, rng: T.random_sample_viewpoint(rng=rng),
        "random_crop_point_cloud_with_point": lambda T, rng: (
            T.random_crop_point_cloud_with_point(cloud, rng=rng),
            T.random_crop_point_cloud_with_point(cloud, keep_ratio=0.3, normals=normals,
                                                 rng=rng)),
    }


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", sorted(_transform_cases()))
@pytest.mark.parametrize("make_rng", [np.random.default_rng, np.random.RandomState])
def test_transforms_equal_jax(name, make_rng):
    case = _transform_cases()[name]
    got, want = _leaves(case(ttr, make_rng(5))), _leaves(case(jtr, make_rng(5)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_transforms_cover_jax():
    public = {n for n, f in vars(jtr).items() if callable(f) and not n.startswith("_")}
    assert public == {n for n, f in vars(ttr).items() if callable(f) and not n.startswith("_")}
    assert public == set(_transform_cases())
