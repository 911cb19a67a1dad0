"""The offline CLIs' programs, what the CPU can show of them.

On the card ``test`` replays one captured program per capacity bucket of its
forward with ground truth (``cli/test.py::_make_eval_program``), ``infer``
replays ``models.capture_pipeline`` and RANSAC one program per capacity
(``ops/ransac.py::capture_ransac``, at most 32 over one graph pool). A CUDA
graph cannot run here, so these tests hold:

* no op reads a value back to the host in the with-ground-truth forward
  with its build and the Evaluator, nor in ``ransac_registration`` (the
  ``TorchDispatchMode`` of ``test_torch_port_train_program.py``; the plain
  versions of the card's kernels are excepted by name there: on the CPU
  Horn's eigenvectors come from ``torch.linalg.eigh``, which on CUDA waits
  for the host and which the card replaces by ``eigh4``);
* ``run_eval_loop`` with a forward that writes every pair into the same
  output tensors, as a replay does, dumps and logs what the eager loop does;
* RANSAC with the threshold as a 0-d tensor (a program's input) equals the
  float threshold bit for bit and JAX's ``ransac_registration`` on the same
  uniforms within 1e-5, at thresholds whose float32 square differs from
  the rounded float64 one;
* the program cache: one program a shape, at most 32, least recently used
  out, one pool;
* the programs refuse the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rdmnet_tpu_torch.cli import test as test_cli
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset, write_procedural_root
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.losses import Evaluator
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.ops import ransac
from rdmnet_tpu_torch.ops.ransac import ransac_registration
from rdmnet_tpu_torch.program import StepProgram
from test_torch_port_ransac import _both, _correspondences, _padded
from test_torch_port_train_program import host_reads, one_thread  # noqa: F401 (fixtures)

CAP = 512


def _pair(seed=11):
    ref, src, tf = procedural_pair(seed, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(seed)
    return ref[rng.permutation(len(ref))[:500]], src[rng.permutation(len(src))[:480]], tf


def _padded_pair(ref, src):
    from rdmnet_tpu_torch.graph.pyramid import pad_cloud

    rp, rc = pad_cloud(ref, CAP, device="cpu")
    sp, sc = pad_cloud(src, CAP, device="cpu")
    return rp, rc, sp, sc


def test_eval_forward_with_its_build_reads_nothing_back(host_reads, one_thread):  # noqa: F811
    """The body a test program captures: the build from the staged inputs,
    the model with ground truth, the Evaluator and ``dropped``."""
    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    body = test_cli._eval_body(cfg, model, Evaluator(cfg))
    ref, src, tf = _pair()
    inputs = (*_padded_pair(ref, src), torch.from_numpy(tf.astype(np.float32)))
    with host_reads:
        out, metrics = body(*inputs)
    assert set(metrics) >= {"PIR", "IR", "RRE", "RTE", "RR", "dropped"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert out["estimated_transform"].shape == (4, 4)


@pytest.mark.parametrize("threshold", [0.3, torch.tensor(0.3)])
def test_ransac_reads_nothing_back(threshold, host_reads):  # noqa: F811
    src, ref, tf = _correspondences(1, 300, 0.4)
    s, r, m = (torch.from_numpy(a) for a in _padded(src, ref, CAP))
    with host_reads:
        got = ransac_registration(s, r, m, torch.Generator().manual_seed(5), num_iterations=700,
                                  chunk=256, threshold=threshold, fallback_weights=torch.ones(CAP))
    np.testing.assert_allclose(got.numpy(), tf, atol=1e-2)


@pytest.mark.parametrize("case", ["refit", "no_refit", "fallback"])
@pytest.mark.parametrize("thr", [0.3, 0.35, 0.45])
def test_ransac_threshold_tensor_matches_float_and_jax(case, thr):
    """0.35 and 0.45 square to other float32 values than their float64
    squares: both sides square the float32 threshold."""
    if case == "refit":
        src, ref, _ = _correspondences(1, 300, 0.4)
        iters, w = 700, None
    elif case == "no_refit":  # a threshold no residual passes: thr / 1e8
        src, ref, _ = _correspondences(2, 40, 1.0, box=4.0)
        iters, w, thr = 300, None, thr * 1e-8
    else:  # fewer valid rows than samples
        src, ref, _ = _correspondences(3, 3, 1.0, box=4.0)
        iters = 256
        w = np.zeros(CAP, np.float32)
        w[:3] = [0.2, 1.0, 0.7]
    s, r, m = _padded(src, ref, CAP)
    got, want = _both(s, r, m, iters=iters, chunk=256, thr=thr, w=w)
    np.testing.assert_allclose(got, want, atol=1e-5)
    u = torch.rand(-(-iters // 256), 256, 4, generator=torch.Generator().manual_seed(9))
    args = [torch.from_numpy(a) for a in (s, r, m)] + [u]
    kw = dict(num_iterations=iters, chunk=256,
              fallback_weights=None if w is None else torch.from_numpy(w))
    a = ransac_registration(*args, threshold=thr, **kw)
    b = ransac_registration(*args, threshold=torch.tensor(thr, dtype=torch.float32), **kw)
    assert torch.equal(a, b)


def test_host_ransac_on_the_cpu_is_the_eager_solver():
    src, ref, _ = _correspondences(4, 700, 0.5)
    w = np.random.RandomState(0).rand(700).astype(np.float32)
    got = ransac.ransac_registration_host(src, ref, w, num_iterations=3000, threshold=0.35,
                                          seed=4, device="cpu")
    cap, chunk = ransac.ransac_capacity(700)
    s, r, m = _padded(src, ref, cap)
    ww = np.zeros(cap, np.float32)
    ww[:700] = w
    want = ransac.eager_solver(cap, chunk, 3000, 4, torch.device("cpu"))(s, r, m, ww, 0.35, 4)
    assert np.array_equal(got, want.numpy().astype(np.float64))


def test_ransac_programs_are_cached_by_shape(monkeypatch):
    """On the card ``solver`` keeps one program a (capacity, chunk,
    iterations, samples), at most ``MAX_PROGRAMS``, the least recently used
    dropped first, every program over one graph pool."""
    captured = []

    def fake_capture(cap, chunk, iters, samples, device, pool):
        captured.append(((cap, chunk, iters, samples), pool))
        return object()

    monkeypatch.setattr(ransac, "capture_ransac", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    ransac._program.cache_clear()
    ransac._pool.cache_clear()
    try:
        card = torch.device("cuda")
        first = ransac.solver(512, 2048, 50000, 4, card)
        assert ransac.solver(512, 2048, 50000, 4, card) is first
        for i in range(1, ransac.MAX_PROGRAMS + 5):
            ransac.solver(512 * (i + 1), 2048, 50000, 4, card)
            if i == ransac.MAX_PROGRAMS - 2:
                assert ransac.solver(512, 2048, 50000, 4, card) is first  # used: kept
        assert ransac._program.cache_info().currsize == ransac.MAX_PROGRAMS
        assert ransac.solver(512, 2048, 50000, 4, card) is first
        assert len(captured) == ransac.MAX_PROGRAMS + 5
        assert len({id(pool) for _, pool in captured}) == 1
        ransac.solver(1024, 2048, 50000, 4, card)  # dropped earlier: captured anew
        assert len(captured) == ransac.MAX_PROGRAMS + 6
    finally:
        ransac._program.cache_clear()
        ransac._pool.cache_clear()


def _dumps_and_lines(tmp_path, root, name, monkeypatch=None, aliasing=False):
    cfg = make_tiny_cfg()
    cfgs = [dataclasses.replace(cfg, pyramid=cfg.pyramid.scaled(s)) for s in (0.5, 1.0)]
    model = RDMNet(cfgs[-1], device="cpu", generator=torch.Generator().manual_seed(2))
    dataset = RegistrationPairDataset("kitti", root=str(root), subset="test",
                                      point_limit=cfg.test.point_limit)
    if aliasing:
        eager = test_cli._make_eval_forward

        def one_output_set(c, m, evaluator, dev):
            """A forward that returns the same tensors every call, as a
            replayed program does: each pair overwrites the last."""
            forward, slots = eager(c, m, evaluator, dev), {}

            def run(*args):
                out, metrics = forward(*args)
                return tuple({k: slots.setdefault((tag, k), torch.empty_like(v)).copy_(v)
                              for k, v in part.items() if isinstance(v, torch.Tensor)}
                             for tag, part in (("out", out), ("metrics", metrics)))
            return run

        monkeypatch.setattr(test_cli, "_make_eval_forward", one_output_set)
    lines = []
    feature_dir = tmp_path / name
    feature_dir.mkdir()
    test_cli.run_eval_loop(cfgs[-1], model, dataset, list(range(len(dataset))), str(feature_dir),
                           log=lines.append, cfgs=cfgs, device="cpu",
                           vis_dir=str(feature_dir / "vis"))
    dumps = {p.name: dict(np.load(p)) for p in sorted(feature_dir.glob("*.npz"))}
    return dumps, [line.split(" | prep")[0] for line in lines]


def test_eval_loop_copies_outputs_before_the_next_forward(tmp_path, monkeypatch, one_thread):  # noqa: F811
    """Three pairs in one bucket through a forward whose outputs are
    overwritten by the next call: dumps and logged metrics equal the eager
    loop's (the loop keeps one pair in flight, so it must copy a pair's
    outputs out before it issues the next forward)."""
    root = tmp_path / "kitti"
    write_procedural_root(str(root), "kitti", {8: (5, 4)}, n_rings=16, n_azimuths=200)
    want, want_lines = _dumps_and_lines(tmp_path, root, "eager")
    got, got_lines = _dumps_and_lines(tmp_path, root, "aliased", monkeypatch, aliasing=True)
    assert len(want) == 3 and sorted(got) == sorted(want)
    for name, arrays in want.items():
        assert sorted(got[name]) == sorted(arrays)
        for k, v in arrays.items():
            assert np.array_equal(got[name][k], v), (name, k)
    assert got_lines == want_lines and len(set(want_lines)) == 3
    for name in want:
        assert (tmp_path / "aliased" / "vis" / name[:-4] / "viewer.html").exists()


def test_programs_refuse_the_cpu():
    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="capture_ransac: a CUDA graph needs a CUDA device"):
        ransac.capture_ransac(512, 2048, 5000, 4, "cpu")
    with pytest.raises(ValueError, match="test forward program: a CUDA graph needs a CUDA"):
        test_cli._make_eval_program(cfg, model, Evaluator(cfg), torch.device("cpu"))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        StepProgram("a program", lambda static: None, dict, {}, torch.device("cpu"))


def test_infer_forward_on_the_cpu_is_make_forward():
    from rdmnet_tpu_torch.cli import common, infer

    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    ref, src, _ = _pair(12)
    padded = common.pad_pair_np(cfg, ref, src)
    got = infer._make_forward(cfg, model, "cpu")(*padded)
    want = common.make_forward(cfg, model, with_gt=False, device="cpu")(
        *padded, np.eye(4, dtype=np.float32))
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
