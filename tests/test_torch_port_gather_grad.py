"""The sentinel gathers' backward (``ops/kernels/gather_grad``) on the CPU.

``take_padded`` under autograd runs its lookup inside ``_TakePadded``, whose
backward is the gather-sum: on the card the kernel of
``csrc/gather_grad.cu``, here its plain version. These tests hold the plain
version bit for bit to the gradient of the embedding lookup the port ran
before (float32; bfloat16 against that gradient taken in float32 and
rounded once, which is what the kernel writes), to JAX's gradient of
``jnp.take(mode="fill")``, and to ``gradcheck`` in float64; a tiny train
step's gradients equal the embedding backward's bit for bit; without
autograd ``take_padded`` is the lookup alone and launches nothing. The
kernel against the plain version is in ``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdmnet_tpu.ops import geometry as jgeo
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
from rdmnet_tpu_torch.graph.pyramid import pad_cloud
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.nn.point_matching import group_and_aggregate
from rdmnet_tpu_torch.ops import geometry
from rdmnet_tpu_torch.ops.kernels import all_launch_counts
from rdmnet_tpu_torch.ops.kernels import gather_grad as gather_grad_module
from rdmnet_tpu_torch.ops.kernels.gather_grad import gather_grad, gather_grad_plain
from rdmnet_tpu_torch.ops.radius_search import radius_knn

SHAPES = [(), (3,), (37,), (4, 5)]  # x's trailing dims: (N,), points, odd C, two axes


def _table(case, n, seed):
    """(30, 7) indices into n rows: random with sentinels beyond n and
    duplicates; a single row every position references; all sentinel; or
    sentinels equal to n only, as the pyramid's tables hold them."""
    rng = np.random.RandomState(seed)
    if case == "random":
        idx = rng.randint(0, int(n * 1.6) + 3, size=(30, 7))
    elif case == "one_row":
        idx = np.full((30, 7), n // 2)
    elif case == "sentinel":
        idx = rng.randint(n, n + 50, size=(30, 7))
    else:
        idx = np.where(rng.rand(30, 7) < 0.6, n, rng.randint(0, n, size=(30, 7)))
    return torch.from_numpy(idx.astype(np.int32))


def _embedding_grad(x, idx, gout):
    """The gradient of the lookup as the port ran it before: the embedding
    backward, through autograd."""
    leaf = x.detach().clone().requires_grad_()
    geometry._lookup(leaf, idx, 0.0).backward(gout)
    return leaf.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "one_row", "sentinel", "pyramid"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gradient_bit_equal_to_the_embedding_backward(shape, case, dtype):
    n = 50
    gen = torch.Generator().manual_seed(len(shape) * 7 + len(case))
    x = torch.randn((n,) + shape, generator=gen).to(dtype)
    idx = _table(case, n, seed=len(case))
    gout = torch.randn(tuple(idx.shape) + shape, generator=gen).to(dtype)
    leaf = x.clone().requires_grad_()
    geometry.take_padded(leaf, idx).backward(gout)
    want = _embedding_grad(x.float(), idx, gout.float()).to(dtype)
    assert leaf.grad.dtype == dtype and leaf.grad.shape == x.shape
    assert torch.equal(leaf.grad.view(torch.uint8) if dtype == torch.bfloat16 else leaf.grad,
                       want.view(torch.uint8) if dtype == torch.bfloat16 else want)
    if case == "sentinel":
        assert not leaf.grad.any()


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_plain_version_rows(index_dtype):
    """Rows nothing references are 0, a negative index is a sentinel, and a
    row's sum runs in position order from +0 (-0 rows sum to +0)."""
    grad = torch.tensor([[1.0, -0.0], [1e8, -0.0], [1.0, -0.0], [-1e8, -0.0], [5.0, 5.0]])
    idx = torch.tensor([2, 2, 2, 2, -1], dtype=index_dtype)
    got = gather_grad_plain(grad, idx, 4)
    # ((0 + 1) + 1e8) + 1 = 1e8 in float32, minus 1e8: 0, not 1 or 2
    assert torch.equal(got, torch.zeros(4, 2))
    assert not torch.signbit(got).any()
    assert torch.equal(gather_grad(grad, idx, 4), got)
    assert gather_grad_plain(grad[:0], idx[:0], 3).shape == (3, 2)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("fill", [0.0, 7.0])
def test_take_padded_gradcheck_float64(shape, fill):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((12,) + shape, generator=gen, dtype=torch.float64, requires_grad=True)
    idx = _table("random", 12, seed=4)[:6, :5]
    assert torch.autograd.gradcheck(lambda a: geometry.take_padded(a, idx, fill), (x,))


@pytest.mark.parametrize("shape", [(3,), (37,)], ids=str)
def test_gradient_equals_jax_take_fill(shape):
    """The plain version against JAX's gradient of ``jnp.take(mode="fill")``
    (XLA's scatter-add), float32, bit for bit."""
    rng = np.random.RandomState(8)
    x = rng.randn(40, *shape).astype(np.float32)
    idx = _table("random", 40, seed=9).numpy()
    gout = rng.randn(*idx.shape, *shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda a: jnp.sum(jgeo.take_padded(a, idx) * gout)))(x)
    leaf = torch.from_numpy(x).requires_grad_()
    geometry.take_padded(leaf, torch.from_numpy(idx)).backward(torch.from_numpy(gout))
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["no_grad", "x_without_grad", "inference_mode"])
def test_take_padded_without_autograd_is_the_lookup(mode):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(20, 6, generator=gen)
    idx = _table("random", 20, seed=6)
    want = geometry._lookup(x, idx, 7.0)
    before = all_launch_counts()
    if mode == "no_grad":
        with torch.no_grad():
            got = geometry.take_padded(x.requires_grad_(), idx, 7.0)
    elif mode == "inference_mode":
        with torch.inference_mode():
            got = geometry.take_padded(x.requires_grad_(), idx, 7.0)
    else:
        got = geometry.take_padded(x, idx, 7.0)
    assert got.grad_fn is None and torch.equal(got, want)
    assert all_launch_counts() == before


def test_group_and_aggregate_gradient_never_reaches_the_fill():
    """Under grad the -inf fill of ``group_and_aggregate`` stays in the
    forward: the features' gradient is finite and the embedding backward's."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.rand(30, 3).astype(np.float32) * 4)
    q[:5] += 100.0  # empty groups: every row of their tables is the sentinel
    s = torch.from_numpy(rng.rand(64, 3).astype(np.float32) * 4)
    feats = torch.from_numpy(rng.randn(64, 9).astype(np.float32))
    count = torch.tensor(50, dtype=torch.int32)
    leaf = feats.clone().requires_grad_()
    pooled, sizes = group_and_aggregate(q, s, leaf, count, 1.5, 8)
    gout = torch.from_numpy(rng.randn(*pooled.shape).astype(np.float32))
    pooled.backward(gout)
    assert (sizes == 0).any() and (sizes == 8).any() and torch.isfinite(leaf.grad).all()
    old = feats.clone().requires_grad_()
    table = radius_knn(q, s, count, 1.5, 8)
    want = geometry._lookup(old, table, float("-inf")).amax(dim=1)
    torch.where(sizes[:, None] > 0, want, torch.zeros_like(want)).backward(gout)
    assert torch.equal(leaf.grad, old.grad)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair():
    ref, src, gt = procedural_pair(7354, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(1)
    ref, src = ref[rng.permutation(len(ref))[:500]], src[rng.permutation(len(src))[:480]]
    (rp, rc), (sp, sc) = pad_cloud(ref, 512), pad_cloud(src, 512)
    return {"ref_points": rp.numpy()[None], "ref_counts": rc.numpy()[None],
            "src_points": sp.numpy()[None], "src_counts": sc.numpy()[None],
            "transform": gt[None].astype(np.float32)}


def test_train_step_gradients_equal_the_embedding_backwards(one_thread, monkeypatch):
    """A tiny train step's metrics and every gradient, with the gather-sum
    and with the embedding backward in its place, bit for bit; the step
    differentiates through at least one gather a level."""
    cfg = make_tiny_cfg()
    host = _pair()
    runs = []
    calls = []
    plain = gather_grad_plain

    def counted(grad, idx, n):
        calls.append(n)
        return plain(grad, idx, n)

    for old in (False, True):
        with monkeypatch.context() as patch:
            if old:
                patch.setattr(geometry._TakePadded, "apply",
                              lambda x, idx, fill: geometry._lookup(x, idx, fill))
            else:
                patch.setattr(gather_grad_module, "gather_grad_plain", counted)
            model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
            state = create_train_state(cfg, model, steps_per_epoch=10)
            batch = batch_to_device(host, cfg.pyramid, device="cpu")
            runs.append(make_value_and_grad(cfg, device="cpu")(
                state, batch, torch.Generator().manual_seed(1)))
    (new_m, new_g), (old_m, old_g) = runs
    assert all(torch.equal(new_m[k], old_m[k]) for k in old_m)
    assert len(new_g) == len(old_g) and all(torch.equal(a, b) for a, b in zip(new_g, old_g))
    assert len(calls) >= cfg.pyramid.num_stages
