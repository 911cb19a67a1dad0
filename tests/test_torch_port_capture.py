"""The serving program's ops without host round trips, on the CPU.

The port captures each bucket's pipeline as a CUDA graph on the card
(``models.capture_pipeline``); for that its graph build, NMS and Horn solver
run there on three kernels of its own (``ops/kernels/segment_sum``, ``nms``,
``eigh4``). The CPU keeps their plain versions, which these tests hold to
the JAX package: NMS keep masks equal to ``greedy_nms``'s (random nodes, a
truncated adjacency, masked nodes, a suppression chain of 64 rounds), voxel
centroids bit-equal to ``grid_subsample``'s (a voxel of 3000 points, the
procedural pair's levels), Horn poses within 1e-4 of JAX's Procrustes (the
tolerance of ``test_torch_port_ops.py``). The dispatch of the new kernels is
held with a tensor that reports itself on CUDA: it takes the kernel's
wrapper, never the plain version, and a launch that fails raises. The
capture refuses the CPU; the CPU's ``serve`` stays eager and thread-safe.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu import config as jcfg
from rdmnet_tpu.ops.grid_subsample import grid_subsample as jax_grid_subsample
from rdmnet_tpu.ops.nms import greedy_nms as jax_nms
from rdmnet_tpu.ops.procrustes import weighted_procrustes as jax_procrustes
from rdmnet_tpu_torch import serving
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data import procedural as tproc
from rdmnet_tpu_torch.data.loader import pad_points_np
from rdmnet_tpu_torch.models import RDMNet, capture_pipeline, pipeline, with_pyramid
from rdmnet_tpu_torch.ops.grid_subsample import grid_subsample
from rdmnet_tpu_torch.ops.kernels import eigh4 as eigh4_module
from rdmnet_tpu_torch.ops.kernels import nms as nms_module
from rdmnet_tpu_torch.ops.kernels import segment_sum as segment_module
from rdmnet_tpu_torch.ops.nms import greedy_nms
from rdmnet_tpu_torch.ops.procrustes import horn_matrix, horn_rotation, weighted_procrustes

T = torch.from_numpy
TOL = dict(rtol=1e-4, atol=1e-4)


def _chain(m, radius, spacing=0.9):
    """m nodes on a line ``spacing * radius`` apart: node i suppresses i + 1
    only, so the peeling confirms one node every second round."""
    nodes = np.zeros((m, 3), np.float32)
    nodes[:, 0] = np.arange(m) * spacing * radius
    return nodes


def _jax_keep(nodes, mask, radius, limit=None):
    return np.asarray(jax.jit(lambda n, k: jax_nms(n, k, radius, neighbor_limit=limit))(
        nodes, mask))


# ------------------------------------------------------------------------ NMS

@pytest.mark.parametrize("case", ["random", "limit", "masked", "chain"])
def test_nms_plain_matches_jax(case):
    rng = np.random.RandomState(7)
    radius, limit = 2.4, None
    if case == "chain":
        nodes = np.stack([_chain(128, radius), _chain(128, radius)[::-1].copy()])
        mask = np.ones((2, 128), bool)
        mask[1, :3] = False
    else:
        nodes = (rng.rand(2, 200, 3) * np.float32([40, 40, 4])).astype(np.float32)
        mask = np.ones((2, 200), bool)
        if case == "masked":
            mask = rng.rand(2, 200) > 0.3
        if case == "limit":
            radius, limit = 6.0, 5
    keep, rounds = greedy_nms(T(nodes), T(mask), radius, neighbor_limit=limit)
    assert rounds.dtype == torch.int32 and rounds.dim() == 0
    for b in range(2):
        np.testing.assert_array_equal(keep[b].numpy(), _jax_keep(nodes[b], mask[b], radius, limit))
    assert not (keep.numpy() & ~mask).any()
    if case == "chain":
        assert int(rounds) >= 50  # one node a second round along the 128-node chain
        np.testing.assert_array_equal(keep[0].numpy(), np.arange(128) % 2 == 0)
    else:
        assert 1 <= int(rounds) < 200


def test_nms_peel_plain_rounds_are_the_clouds_maximum():
    """The plain loop runs while any cloud has an active node: its rounds
    are the larger cloud's (the kernel's wrapper takes the clouds' maximum)."""
    radius = 2.4
    nodes = np.stack([_chain(40, radius), _chain(40, radius)])
    mask = np.stack([np.ones(40, bool), np.arange(40) < 10])
    _, both = greedy_nms(T(nodes), T(mask), radius)
    _, first = greedy_nms(T(nodes[:1]), T(mask[:1]), radius)
    _, second = greedy_nms(T(nodes[1:]), T(mask[1:]), radius)
    assert int(both) == max(int(first), int(second)) == int(first) > int(second)
    _, none = greedy_nms(T(nodes), T(np.zeros((2, 40), bool)), radius)
    assert int(none) == 0


@pytest.mark.parametrize("m, path", [(40, "shared"), (640, "shared"), (1348, "shared"),
                                     (1349, "device"), (1600, "device")])
def test_nms_rows_leave_shared_memory_past_1348(m, path, monkeypatch):
    """The kernel packs the rows into shared memory while they fit (M <=
    1348, 54,000 bytes at the 1.0 bucket's 640), past that into a scratch
    buffer of (B, M, ceil(M / 32)) words the wrapper hands it."""
    assert nms_module.smem_bytes(640) == 4 * (3 * 20 + 640 * 21) == 54_000
    assert (nms_module.smem_bytes(m) <= nms_module.SMEM_MAX) == (path == "shared")
    seen = []

    def launch(c_fn, device, adj, mask, b, rows, scratch, keep, rounds):
        seen.append((b, rows, scratch))
        return 0

    monkeypatch.setattr(nms_module, "launch", launch)
    monkeypatch.setattr(nms_module, "_launcher", lambda: None)
    before = dict(nms_module.nms_peel_cuda.path_launches)
    keep, rounds = nms_module.nms_peel_cuda(_card(torch.zeros((2, m, m), dtype=torch.bool)),
                                            _card(torch.ones((2, m), dtype=torch.bool)))
    assert keep.shape == (2, m) and keep.dtype == torch.bool and rounds.dim() == 0
    assert seen[0][:2] == (2, m) and (seen[0][2] is None) == (path == "shared")
    after = nms_module.nms_peel_cuda.path_launches
    assert {k: after[k] - before[k] for k in after} == {"shared": path == "shared",
                                                        "device": path == "device"}


# ---------------------------------------------------------------- segment sums

def _jax_subsample(pts, n, voxel, cap):
    return [np.asarray(x) for x in jax.jit(lambda p: jax_grid_subsample(
        p, jnp.int32(n), voxel, cap, return_dropped=True))(pts)]


def test_segment_sums_bit_equal_to_jax_on_a_dense_voxel():
    """3000 points in one 0.5 m voxel beside a scattered cloud: the long
    segment's float32 sum, added in order, equals XLA's segment_sum bit for
    bit (a pairwise or reordered sum would not)."""
    rng = np.random.RandomState(3)
    dense = (rng.rand(3000, 3) * 0.49 + np.float32([10.0, 10.0, 1.0])).astype(np.float32)
    scatter = (rng.rand(2000, 3) * 60 - 30).astype(np.float32)
    pts = np.concatenate([scatter[:1000], dense, scatter[1000:]])
    n, cap = len(pts), 2048
    padded = np.full((n + 100, 3), 1e9, np.float32)
    padded[:n] = pts
    want = _jax_subsample(padded, n, 0.5, cap)
    got = grid_subsample(T(padded)[None], torch.tensor([n], dtype=torch.int32), 0.5, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w)
    # the dense voxel's sum, straight from the plain version
    sums = segment_module.segment_sums_plain(T(dense)[None], torch.tensor([[0]]),
                                             torch.tensor([[3000]]))
    acc = np.zeros(3, np.float32)
    for row in dense:
        acc = (acc + row).astype(np.float32)
    np.testing.assert_array_equal(sums[0, 0].numpy(), acc)


def test_segment_sums_bit_equal_to_jax_on_the_pair_levels():
    """The procedural pair's levels 1-4 at the tiny config's caps, each from
    the previous, both clouds as one batch."""
    spec = make_tiny_cfg().pyramid
    ref, src, _ = tproc.procedural_pair(31, n_rings=16, n_azimuths=200)
    clouds = []
    for pts in (ref, src):
        padded, n = pad_points_np(pts, spec.caps[0])
        clouds.append((padded, int(n)))
    tp = T(np.stack([c[0] for c in clouds]))
    tc = torch.tensor([c[1] for c in clouds], dtype=torch.int32)
    jp = [c[0] for c in clouds]
    jc = [c[1] for c in clouds]
    voxel = spec.voxel_size
    for lvl in range(1, spec.num_stages):
        voxel *= 2.0
        tp, tc, _ = grid_subsample(tp, tc, voxel, spec.caps[lvl])
        for b in range(2):
            want = _jax_subsample(jp[b], jc[b], voxel, spec.caps[lvl])
            np.testing.assert_array_equal(tp[b].numpy(), want[0], err_msg=f"level {lvl}")
            np.testing.assert_array_equal(int(tc[b]), int(want[1]))
            jp[b], jc[b] = want[0], int(want[1])


# ------------------------------------------------------------------------ pose

def test_horn_rotation_on_the_cpu_is_eigh():
    """The CPU keeps ``torch.linalg.eigh``: the rotation equals the formula
    on its last eigenvector bit for bit."""
    rng = np.random.RandomState(9)
    h = T((rng.randn(64, 3, 3) * 5).astype(np.float32))
    k = horn_matrix(h).clone()
    k[..., 0, 0] += 1e-12 + 1e-9 * h.abs().sum((-1, -2))
    assert torch.equal(eigh4_module.top_eigenvector(k), torch.linalg.eigh(k).eigenvectors[..., -1])
    r = horn_rotation(h)
    assert r.shape == (64, 3, 3)
    np.testing.assert_allclose((r @ r.transpose(1, 2)).numpy(), np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-5)


def test_procrustes_on_the_cpu_matches_jax():
    rng = np.random.RandomState(11)
    src = (rng.randn(16, 40, 3) * 10).astype(np.float32)
    q = rng.randn(16, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rots = []
    for w, x, y, z in q:
        rots.append([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    rots = np.asarray(rots, np.float32)
    ref = (np.einsum("bij,bnj->bni", rots, src) + rng.randn(16, 1, 3) * 3
           + rng.randn(16, 40, 3) * 0.01).astype(np.float32)
    w = rng.rand(16, 40).astype(np.float32)
    w[5] = 0.0  # degenerate: identity
    w[6, 3:] = 0.0  # three correspondences
    want = np.asarray(jax.jit(jax_procrustes)(src, ref, w))
    got = weighted_procrustes(T(src), T(ref), T(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[5], np.eye(4), atol=1e-6)


# ------------------------------------------------------------------- dispatch

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on CUDA: the dispatchers and wrappers
    see a card's tensor, the arithmetic stays on the CPU."""

    @property
    def is_cuda(self):
        return True


def _card(x):
    return torch.as_tensor(x).as_subclass(_OnCard)


def _inputs(kernel):
    rng = np.random.RandomState(0)
    if kernel == "segment_sums":
        pts = rng.rand(2, 20, 3).astype(np.float32)
        return (pts, np.array([[0, 5], [0, 20]]), np.array([[5, 15], [20, 0]]))
    if kernel == "nms_peel":
        return (np.tril(rng.rand(2, 40, 40) > 0.7, -1), rng.rand(2, 40) > 0.2)
    return (np.broadcast_to(np.eye(4, dtype=np.float32), (3, 4, 4)).copy(),)


MODULES = {"segment_sums": (segment_module, "segment_sums", "segment_sums_cuda",
                            "segment_sums_plain"),
           "nms_peel": (nms_module, "nms_peel", "nms_peel_cuda", "nms_peel_plain"),
           "eigh4": (eigh4_module, "top_eigenvector", "eigh4_cuda", "top_eigenvector_plain")}


@pytest.mark.parametrize("kernel", sorted(MODULES))
def test_a_card_tensor_never_takes_the_plain_version(kernel, monkeypatch):
    module, dispatch, wrapper, plain = MODULES[kernel]
    calls = []
    monkeypatch.setattr(module, wrapper, lambda *a: calls.append(a) or "kernel")

    def refuse(*a):
        raise AssertionError("the plain version took a card's tensor")

    monkeypatch.setattr(module, plain, refuse)
    args = [_card(a) for a in _inputs(kernel)]
    assert getattr(module, dispatch)(*args) == "kernel"
    assert len(calls) == 1 and all(a.is_cuda for a in calls[0])


@pytest.mark.parametrize("kernel", sorted(MODULES))
def test_a_failing_launch_raises(kernel, monkeypatch):
    module, _, wrapper, _ = MODULES[kernel]
    fn = getattr(module, wrapper)
    seen = []

    def launch(c_fn, device, *args):
        seen.append(device)
        return c_fn(*args, 0)

    monkeypatch.setattr(module, "launch", launch)
    monkeypatch.setattr(module, "_launcher", lambda: lambda *args: 700)  # an illegal address
    args = [_card(a) for a in _inputs(kernel)]
    if kernel == "segment_sums":
        args = [args[0], args[1].to(torch.int32), args[2].to(torch.int32)]
    before = fn.launches
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        fn(*args)
    assert fn.launches == before and seen


@pytest.mark.parametrize("kernel", sorted(MODULES))
def test_wrappers_refuse_cpu_tensors(kernel):
    module, _, wrapper, _ = MODULES[kernel]
    args = [torch.as_tensor(a) for a in _inputs(kernel)]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(module, wrapper)(*args)


# --------------------------------------------------------- capture and serve

def test_capture_pipeline_raises_on_the_cpu():
    model = RDMNet(make_tiny_cfg(), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        capture_pipeline(model, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        capture_pipeline(model, torch.device("cpu"))


@pytest.fixture(scope="module")
def cpu_artifact(tmp_path_factory):
    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    out_dir = str(tmp_path_factory.mktemp("artifact"))
    serving.export_inference(cfg, model, out_dir, bucket_scales=(0.5, 1.0))
    return out_dir


def _pairs():
    scans, _ = tproc.procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    a = scans[0][rng.permutation(len(scans[0])), :3]
    b = scans[1][rng.permutation(len(scans[1])), :3]
    # sizes that rise, then fall: a request smaller than the last one
    return [(a[:n], b[:n - 7]) for n in (200, 480, 600, 230)]


def test_cpu_serve_is_eager_and_equals_pipeline(cpu_artifact):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serve, meta = serving.load_exported(cpu_artifact, device="cpu")
        assert serve.programs == {}
        buckets = {b["cap"]: b["cfg"] for b in serving.bucket_configs(
            make_tiny_cfg(), [b["scale"] for b in meta["buckets"]])}
        outs = []
        for r, s in _pairs():
            out = serve(r, s)
            cap = serve.last_cap
            view = with_pyramid(serve.model, buckets[cap].pyramid)
            live = pipeline(view, *serving._pad_np(r, cap), *serving._pad_np(s, cap),
                            device="cpu")
            assert live["nms_rounds"].dim() == 0 and live["nms_rounds"].dtype == torch.int32
            for k in serving.SERVE_OUTPUTS:
                np.testing.assert_array_equal(out[k], live[k].numpy(), err_msg=k)
            outs.append(out)
        # threads share the serve function: the lock keeps every answer its own
        got = [None] * 8
        pairs = _pairs()

        def client(i):
            got[i] = serve(*pairs[i % len(pairs)])

        workers = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        for i, out in enumerate(got):
            for k in serving.SERVE_OUTPUTS:
                np.testing.assert_array_equal(out[k], outs[i % len(pairs)][k], err_msg=k)
    finally:
        torch.set_num_threads(threads)


def test_vote_off_rounds_are_a_zero_tensor():
    cfg = make_tiny_cfg()
    cfg = dataclasses.replace(cfg, vote=dataclasses.replace(cfg.vote, model_use_vote=False))
    model = RDMNet(cfg, device="cpu")
    (r, s) = _pairs()[0]
    cap = cfg.pyramid.caps[0]
    out = pipeline(model, *serving._pad_np(r, cap), *serving._pad_np(s, cap), device="cpu")
    assert out["nms_rounds"] == 0 and out["nms_rounds"].dim() == 0
    assert jcfg.make_tiny_cfg().pyramid.caps[0] == cap  # the JAX config's bucket
