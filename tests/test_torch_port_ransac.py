"""The port's device RANSAC and infer CLI against the JAX package's, on the
CPU.

``ransac_registration`` is fed the uniforms ``jax.random.uniform`` draws
inside the JAX version for the same key, so both solve the same hypotheses:
transforms within 1e-5 (float32 Horn solves in other eigensolvers). Each
case keeps the inlier counts of competing hypotheses well apart, so that no
count rests on a residual within float noise of the threshold.
"""

import functools
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from rdmnet_tpu.cli import common as jcommon
from rdmnet_tpu.cli import infer as jinfer
from rdmnet_tpu.data.procedural import procedural_sequence
from rdmnet_tpu.ops import ransac as jransac
from rdmnet_tpu.utils import se3_np as jse3
from rdmnet_tpu_torch.cli import infer
from rdmnet_tpu_torch.ops.ransac import (ransac_capacity, ransac_registration,
                                         ransac_registration_host)
from rdmnet_tpu_torch.utils import se3_np

TOL = 1e-5


def _pose(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    return se3_np.get_transform_from_rotation_translation(rot, rng.randn(3) * 5)


def _correspondences(seed, n, inlier_share, noise=0.02, box=40.0):
    """n correspondences under a known pose, in a cube of side ``box`` about
    the origin: the first share inliers with uniform noise, the rest
    outliers anywhere in the cube."""
    rng = np.random.RandomState(seed)
    tf = _pose(seed)
    src = ((rng.rand(n, 3) - 0.5) * box).astype(np.float32)
    ref = se3_np.apply_transform(src, tf) + (rng.rand(n, 3) - 0.5) * noise
    n_in = int(n * inlier_share)
    ref[n_in:] = (rng.rand(n - n_in, 3) - 0.5) * box
    return src, ref.astype(np.float32), tf


def _padded(src, ref, cap, n_valid=None):
    n = len(src) if n_valid is None else n_valid
    s = np.zeros((cap, 3), np.float32)
    r = np.zeros((cap, 3), np.float32)
    s[:len(src)], r[:len(ref)] = src, ref
    m = np.zeros(cap, bool)
    m[:n] = True
    return s, r, m


def _both(s, r, m, iters, chunk, thr, w=None, key=7):
    """(port, jax) transforms on the same uniforms."""
    k = jax.random.PRNGKey(key)
    n_chunks = max(1, -(-iters // chunk))
    u = np.array(jax.random.uniform(k, (n_chunks, chunk, 4)))
    jfn = jax.jit(functools.partial(jransac.ransac_registration, num_iterations=iters,
                                    num_samples=4, chunk=chunk))
    want = np.asarray(jfn(s, r, m, k, threshold=thr, fallback_weights=w))
    with torch.no_grad():
        got = ransac_registration(
            torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(m), torch.from_numpy(u),
            num_iterations=iters, num_samples=4, chunk=chunk, threshold=thr,
            fallback_weights=None if w is None else torch.from_numpy(w)).numpy()
    return got, want


def _inliers(tf, s, r, m, thr):
    res = np.linalg.norm(r - se3_np.apply_transform(s, tf), axis=1)
    return int(((res < thr) & m).sum())


def test_refit_matches_jax_and_recovers_the_pose():
    src, ref, tf = _correspondences(1, 300, 0.4)
    s, r, m = _padded(src, ref, 512)
    got, want = _both(s, r, m, iters=700, chunk=256, thr=0.3)  # 3 chunks, the last partial
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, tf, atol=1e-2)
    assert _inliers(got, s, r, m, 0.3) == 120


def test_best_hypothesis_without_refit_matches_jax():
    """A threshold below every residual: every hypothesis counts 0 inliers,
    the first one wins (ties keep the earliest) and is returned without the
    refit. All rows are noisy inliers in a small cube, so each 4-point
    hypothesis is well posed."""
    src, ref, tf = _correspondences(2, 40, 1.0, box=4.0)
    s, r, m = _padded(src, ref, 512)
    got, want = _both(s, r, m, iters=300, chunk=256, thr=1e-9)
    assert _inliers(want, s, r, m, 1e-9) == 0
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, tf, atol=0.1)


def test_degenerate_fallback_matches_jax():
    """Fewer valid rows than samples: one weighted Procrustes over them."""
    src, ref, _ = _correspondences(3, 3, 1.0, box=4.0)
    s, r, m = _padded(src, ref, 512)
    w = np.zeros(512, np.float32)
    w[:3] = [0.2, 1.0, 0.7]
    got, want = _both(s, r, m, iters=256, chunk=256, thr=0.3, w=w)
    np.testing.assert_allclose(got, want, atol=TOL)
    got, want = _both(s, r, m, iters=256, chunk=256, thr=0.3)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_uniforms_of_the_wrong_shape_raise():
    s, r, m = _padded(*_correspondences(4, 10, 1.0)[:2], 512)
    with pytest.raises(ValueError, match="uniforms of shape"):
        ransac_registration(torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(m),
                            torch.rand(1, 256, 4), num_iterations=600, chunk=256)


@pytest.mark.parametrize("n", [1, 511, 512, 513, 3000, 9000])
def test_host_wrapper_capacity_and_chunk_match_jax(n, monkeypatch):
    seen = []

    def spy(cap, num_iterations, num_samples, chunk):
        seen.append((cap, chunk))
        return lambda *args: np.eye(4, dtype=np.float32)

    monkeypatch.setattr(jransac, "_compiled", spy)
    pts = np.zeros((n, 3), np.float32)
    jransac.ransac_registration_host(pts, pts, num_iterations=10)
    assert seen == [ransac_capacity(n)]


def test_host_wrapper_matches_jax_on_a_known_pose():
    """Other draws on each side (a torch generator, a JAX key), the same
    inlier set after the refit, so the same transform."""
    src, ref, tf = _correspondences(5, 700, 0.5)
    w = np.linspace(0.1, 1.0, 700).astype(np.float32)
    got = ransac_registration_host(src, ref, w, num_iterations=1000, device="cpu")
    want = jransac.ransac_registration_host(src, ref, w, num_iterations=1000)
    assert got.dtype == want.dtype == np.float64 and got.shape == (4, 4)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, tf, atol=1e-2)


def test_host_wrapper_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, ref, _ = _correspondences(6, 20, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ransac_registration_host(src, ref, num_iterations=10)


def test_se3_np_matches_jax():
    tf = _pose(8)
    pts = np.random.RandomState(8).rand(20, 3)
    np.testing.assert_array_equal(se3_np.apply_transform(pts, tf), jse3.apply_transform(pts, tf))
    np.testing.assert_array_equal(se3_np.inverse_transform(tf), jse3.inverse_transform(tf))
    np.testing.assert_allclose(se3_np.inverse_transform(tf) @ tf, np.eye(4), atol=1e-12)


# ------------------------------------------------------------ infer CLI

def test_format_pose_line_matches_jax():
    rng = np.random.RandomState(9)
    for est in (np.eye(4), rng.randn(4, 4) * 100, rng.randn(4, 4).astype(np.float32)):
        assert infer.format_pose_line(3, 17, est) == jinfer.format_pose_line(3, 17, est)


def test_infer_writes_pose_file_and_npz(tmp_path):
    """The demo-pair loop on procedural clouds named as the bundled scans,
    at the tiny config on the CPU: the pose file's lines, and each npz with
    the JAX package's keys (trimmed outputs plus the RANSAC transform)."""
    assets, out_dir = tmp_path / "pc", tmp_path / "out"
    assets.mkdir()
    scans, _ = procedural_sequence(11, 3, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    for frame, scan in zip((0, 4, 7), scans):
        np.save(assets / f"{frame:06d}.npy", scan[rng.permutation(len(scan))[:450]])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        infer.main(["--device", "cpu", "--cfg_preset", "tiny", "--asset_dir", str(assets),
                    "--output_dir", str(out_dir), "--ransac_iterations", "300"])
    finally:
        torch.set_num_threads(threads)
    lines = (out_dir / "00_pose").read_text().splitlines()
    assert len(lines) == 2

    # the keys the JAX package writes: its trim_outputs on a padded output
    # dict, plus the RANSAC transform
    from rdmnet_tpu_torch.cli import common
    from rdmnet_tpu_torch.config import make_tiny_cfg

    cfg = make_tiny_cfg()
    model = common.build_model_and_params(cfg, device="cpu")
    ref, src = np.load(assets / "000000.npy")[:, :3], np.load(assets / "000004.npy")[:, :3]
    out = common.make_forward(cfg, model, False, device="cpu")(
        *common.pad_pair_np(cfg, ref, src), np.eye(4, dtype=np.float32))
    padded = {k: v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    keys = set(jcommon.trim_outputs(padded, np.eye(4))) | {"ransac_transform"}
    for (ref_frame, src_frame), line in zip([(0, 4), (0, 7)], lines):
        dumped = np.load(osp.join(out_dir, f"0_{src_frame}_{ref_frame}.npz"))
        assert set(dumped.files) == keys
        assert line == jinfer.format_pose_line(ref_frame, src_frame, dumped["estimated_transform"])
        assert dumped["ransac_transform"].shape == (4, 4)
        assert np.isfinite(dumped["ransac_transform"]).all()
        assert len(dumped["corr_scores"]) == len(dumped["ref_corr_points"]) > 0
