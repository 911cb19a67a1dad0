"""Data parallelism and the query-sharded search of the PyTorch port, on the CPU.

Ranks are processes started with the spawn method on gloo, meeting through a
``file://`` store in a temporary directory, each on one thread at
``make_tiny_cfg()``. They import no JAX: this module imports it inside the
fixtures only, which run in the parent.

What is held:
* the world-2 dp step (one pair a rank, rank r's target generator at the
  state a one-process step had at pair r) against the port's one-process
  step on both pairs: losses and ``grad_norm`` within rtol 1e-6, every
  gradient within 1e-6 of the global norm, the ranks' gradients bit-equal.
  The one-process step sums ``grad(loss_i / 2)``, the dp step halves
  ``g_0 + g_1``: the same float operations, since halving is exact;
* the same step against JAX's ``make_value_and_grad`` on the two-pair batch,
  at the tolerances of ``test_torch_port_train.py`` (the pairs' target sets
  fit ``num_targets``, so both sides sample all of them);
* one Adam step with ``scale_lr_by_dp``: the ranks' weights bit-equal, and
  within 1e-7 of one process stepping at lr x 2; ``grad_acc_steps = 2`` the
  same after two micro-batches;
* sharded tables and summed band overflow bit-equal to the unsharded search
  at world 2 and 3 (uneven: the padding path), banded and unbanded, and at
  chunk-aligned shapes equal to JAX's ``sharded_radius_knn`` on a 2-device
  ``("sp",)`` mesh; the sp-sharded ``build_pair_batch`` leaf for leaf equal
  to the unsharded build;
* world 4 as dp 2 x sp 2: the dp loss within rtol 1e-6 of one process, the
  sp tables equal to the unsharded ones;
* ``cli.trainval.main --dp 2 --device cpu`` for an epoch, then ``--resume``:
  rank 1 opens no file for writing, the ranks' weights bit-equal after each
  run, the train shards as JAX's ``PairLoader(num_hosts=2)`` gives them, the
  validation means within 1e-6 of a one-process validation of the snapshot;
* a ``--dp`` that disagrees with the world, and NCCL ranks without a card of
  their own, raise.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.loader import pad_points_np
from rdmnet_tpu_torch.data.procedural import procedural_sequence

CAP = 512
LOSSES = ("loss", "c_loss", "g_loss", "n_loss", "p_loss", "v_loss", "nn_loss", "d_loss")
RADIUS, K = 1.0, 6


# ------------------------------------------------------------------ inputs

def _pair(seed):
    """Frames 0 and 1 of a procedural sequence, subsampled to the tiny level-0
    capacity by ``RandomState(seed)``, with the pose mapping frame 1 onto
    frame 0 (``test_torch_port_train.py``'s pair at seed 0)."""
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(seed)
    ref = scans[0][rng.permutation(len(scans[0]))[:500], :3]
    src = scans[1][rng.permutation(len(scans[1]))[:480], :3]
    (rp, rc), (sp, sc) = pad_points_np(ref, CAP), pad_points_np(src, CAP)
    tf = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    return {"ref_points": rp[None], "ref_counts": np.array([rc]), "src_points": sp[None],
            "src_counts": np.array([sc]), "transform": tf[None]}


def _sorted_cloud(rng, n, cell=0.5):
    """An x-major voxel-sorted cloud in a 40 x 5 x 2 m box (as
    ``tests/test_parallel.py`` makes them)."""
    pts = (rng.rand(n, 3) * np.array([40.0, 5.0, 2.0])).astype(np.float32)
    anchor = np.floor(pts.min(0) / cell) * cell
    c = np.floor((pts - anchor) / cell).astype(np.int64)
    key = (c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]
    return pts[np.argsort(key, kind="stable")]


# search cases: (name, queries, supports, q_count, band_cap or None, chunk)
def _search_cases():
    rng = np.random.RandomState(5)
    s640, s600 = _sorted_cloud(rng, 640), _sorted_cloud(rng, 600)
    q512, q402 = _sorted_cloud(rng, 512), _sorted_cloud(rng, 402)
    two_q = np.stack([q512, _sorted_cloud(rng, 512)])
    two_s = np.stack([s640, _sorted_cloud(rng, 640)])
    return [
        ("unbanded", q402, s600, 402, None, 64),
        ("banded", q512, s640, 512, 256, 64),
        ("banded_overflow", q402, s640, 390, 64, 64),
        ("batched_banded", two_q, two_s, 500, 128, 128),
    ]


def _pair_clouds():
    """The clouds of ``test_parallel.py``'s sharded-pyramid test."""
    rng = np.random.RandomState(3)
    ref = (rng.rand(400, 3) * np.array([40.0, 8.0, 3.0])).astype(np.float32)
    src = (rng.rand(384, 3) * np.array([40.0, 8.0, 3.0])).astype(np.float32)
    return ref, src


def _search(case, group=None):
    """One case through ``sharded_radius_knn`` (with ``group``) or the
    unsharded search: (table, overflow)."""
    from rdmnet_tpu_torch.ops.radius_search import radius_knn, radius_knn_banded
    from rdmnet_tpu_torch.parallel import sharded_radius_knn

    _, q, s, q_count, band, chunk = case
    q, s = torch.from_numpy(q), torch.from_numpy(s)
    batched = q.dim() == 3
    s_count = torch.full((q.shape[0],) if batched else (), s.shape[-2], dtype=torch.int32)
    qc = torch.full_like(s_count, q_count)
    if group is not None:
        return sharded_radius_knn(q, s, s_count, RADIUS, K, group, q_count=qc,
                                  cell=None if band is None else 0.5, band_cap=band,
                                  chunk_size=chunk, return_overflow=True)
    if band is None:
        return radius_knn(q, s, s_count, RADIUS, K), torch.zeros_like(s_count)
    return radius_knn_banded(q, s, s_count, RADIUS, K, cell=0.5, band_cap=band, q_count=qc,
                             chunk_size=chunk)


def _pyramid_leaves(group=None, sp_min_queries=64):
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch

    cfg = make_tiny_cfg()
    ref, src = _pair_clouds()
    (rp, rc), (sp, sc) = pad_points_np(ref, CAP), pad_points_np(src, CAP)
    t = torch.from_numpy
    batch = build_pair_batch(t(rp), t(np.array(rc)), t(sp), t(np.array(sc)), torch.eye(4),
                             cfg.pyramid, sp_group=group, sp_min_queries=sp_min_queries)
    leaves = {}
    for side in ("ref", "src"):
        pyr = getattr(batch, side)
        for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
            for lvl, x in enumerate(getattr(pyr, field)):
                leaves[f"{side}.{field}[{lvl}]"] = x
        leaves[f"{side}.dropped"] = pyr.dropped
    leaves["ref_feats"], leaves["src_feats"] = batch.ref_feats, batch.src_feats
    return leaves


# ------------------------------------------------------------------ ranks

def _rank_main(rank, world, store, out_dir, task, payload):
    """Entry of a spawned rank: one thread, gloo through the file store (the
    trainval task joins through the CLI's flags instead), the task, its
    result saved as ``rank<r>.pt``."""
    torch.set_num_threads(1)
    from rdmnet_tpu_torch.parallel import initialize_distributed

    if task != "_task_trainval":
        initialize_distributed(backend="gloo", init_method=f"file://{store}", world_size=world,
                               rank=rank)
    try:
        result = globals()[task](rank, world, dict(payload or {}, store=store))
        result["jax_imported"] = any(m.split(".")[0] in ("jax", "rdmnet_tpu") for m in sys.modules)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(tmp_path, task, world, payload=None, timeout=300):
    """Run ``task`` on ``world`` spawned ranks; their results by rank."""
    import torch.multiprocessing as mp

    out = tmp_path / f"{task}-{world}"
    out.mkdir()
    ctx = mp.start_processes(_rank_main, args=(world, str(out / "store"), str(out), task,
                                               payload), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task} at world {world} ran past {timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _vag_on_rank(cfg, payload, pair, state_index, group, dp_size):
    """This rank's dp value-and-grad on pair ``pair``, the target generator
    at the one-process step's state ``state_index``."""
    from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
    from rdmnet_tpu_torch.models import RDMNet

    model = RDMNet(cfg, device="cpu")
    model.load_state_dict(payload["state_dict"], strict=True)
    state = create_train_state(cfg, model, steps_per_epoch=10, dp_size=dp_size)
    gen = torch.Generator()
    gen.set_state(payload["gen_states"][state_index])
    batch = batch_to_device(payload["pairs"][pair], cfg.pyramid, device="cpu")
    metrics, grads = make_value_and_grad(cfg, "cpu", group)(state, batch, gen)
    return state, batch, metrics, grads


def _task_world2(rank, world, payload):
    from rdmnet_tpu_torch.engine import create_train_state, make_train_step
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.parallel import replicate

    cfg = make_tiny_cfg()
    group = dist.group.WORLD
    # rank 0's weights reach a rank whose model was drawn otherwise
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(99 + rank))
    if rank == 0:
        model.load_state_dict(payload["state_dict"], strict=True)
    replicate(model, group)
    replicated = all(torch.equal(v, payload["state_dict"][k])
                     for k, v in model.state_dict().items())

    state, batch, metrics, grads = _vag_on_rank(cfg, payload, rank, rank, group, world)
    grads = [g.clone() for g in grads]
    applied = state.apply_gradients(grads)
    params1 = [p.detach().clone() for p in state.params]

    acc_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=2))
    acc_model = RDMNet(acc_cfg, device="cpu")
    acc_model.load_state_dict(payload["state_dict"], strict=True)
    acc_state = create_train_state(acc_cfg, acc_model, steps_per_epoch=10, dp_size=world)
    step = make_train_step(acc_cfg, "cpu", group)
    gen = torch.Generator()
    for micro in range(2):
        gen.set_state(payload["gen_states"][2 * micro + rank])
        acc_state, _ = step(acc_state, batch, gen)
    return dict(replicated=replicated, metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, applied=applied, params1=params1, acc_count=acc_state.count,
                acc_params=[p.detach().clone() for p in acc_state.params],
                searches={c[0]: _search(c, group) for c in _search_cases()},
                pyramid=_pyramid_leaves(group))


def _task_world3(rank, world, payload):
    return dict(searches={c[0]: _search(c, dist.group.WORLD) for c in _search_cases()},
                pyramid=_pyramid_leaves(dist.group.WORLD))


def _task_mesh(rank, world, payload):
    from rdmnet_tpu_torch.ops.radius_search import radius_knn
    from rdmnet_tpu_torch.parallel import make_mesh, sharded_radius_knn

    cfg = make_tiny_cfg()
    mesh = make_mesh(dp=2, sp=2)
    _, batch, metrics, _ = _vag_on_rank(cfg, payload, mesh.dp_rank, mesh.dp_rank, mesh.dp_group,
                                        mesh.dp)
    pts, cnt = batch[0].ref.points[0], batch[0].ref.counts[0]
    want = radius_knn(pts, pts, cnt, cfg.pyramid.search_radius, cfg.pyramid.neighbor_limits[0])
    got = sharded_radius_knn(pts, pts, cnt, cfg.pyramid.search_radius,
                             cfg.pyramid.neighbor_limits[0], mesh.sp_group, q_count=cnt,
                             chunk_size=64)
    return dict(mesh=(mesh.dp, mesh.sp, mesh.dp_rank, mesh.sp_rank),
                loss=float(metrics["loss"]), sp_equal=torch.equal(got, want))


def _task_trainval(rank, world, payload):
    """``trainval.main --dp 2`` for an epoch, then resumed for a second; the
    weights after each run, the items each train loader built, and (rank 1)
    every file opened for writing under the output directory."""
    from rdmnet_tpu_torch.cli import trainval
    from rdmnet_tpu_torch.data.loader import PairLoader

    out_dir = payload["output_dir"]
    writes = []
    if rank != 0:
        def audit(event, args):
            if event == "open" and str(args[0]).startswith(out_dir):
                mode, flags = args[1], args[2]
                if (mode and any(c in mode for c in "wax+")) or \
                        (flags and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
                    writes.append((event, str(args[0])))
            elif event in ("os.rename", "os.remove", "shutil.rmtree") \
                    and str(args[0]).startswith(out_dir):
                writes.append((event, str(args[0])))

        sys.addaudithook(audit)
    built = []
    make_batch = PairLoader._make_batch

    def spy(self, items):
        built.append((self.dataset.subset, [(it["seq_id"], it["ref_frame"], it["src_frame"])
                                            for it in items]))
        return make_batch(self, items)

    PairLoader._make_batch = spy
    # the first run joins the group through the multi-host flags (gloo with
    # --device cpu); the resumed one finds it joined
    argv = ["--root", payload["root"], "--output_dir", out_dir, "--device", "cpu",
            "--cfg_preset", "tiny", "--log_steps", "1", "--dp", "2", "--multihost",
            "--coordinator_address", f"file://{payload['store']}", "--num_processes", str(world),
            "--process_id", str(rank)]
    first = trainval.main(argv + ["--max_epoch", "1"])
    backend = dist.get_backend()
    weights = [{k: v.clone() for k, v in first.state.model.state_dict().items()}]
    shard = (first.train_loader.num_hosts, first.train_loader.host_id,
             first.val_loader.num_hosts, first.val_loader.host_id)
    lr = first.state.optimizer.param_groups[0]["lr"]
    second = trainval.main(argv + ["--max_epoch", "2", "--resume"])
    weights.append({k: v.clone() for k, v in second.state.model.state_dict().items()})
    return dict(weights=weights, built=built, writes=writes, shard=shard, lr=lr,
                backend=backend, epochs=(first.epoch, second.epoch), steps=second.state.count,
                val_pairs=[t["pairs"] for t in first.val_timings + second.val_timings])


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def one_process():
    """The JAX two-pair step and the port's one-process step on the same
    weights (JAX's initial ones), with the target generator's state before
    each pair of two micro-batches."""
    import jax

    from rdmnet_tpu.config import make_tiny_cfg as jax_tiny_cfg
    from rdmnet_tpu.engine import train_step as jts
    from rdmnet_tpu.engine.trainer import batch_to_device as jax_batch_to_device
    from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.utils.convert import params_from_jax

    pairs = [_pair(0), _pair(1)]
    both = {k: np.concatenate([p[k] for p in pairs]) for k in pairs[0]}
    jcfg = jax_tiny_cfg()
    jcfg = dataclasses.replace(jcfg, pyramid=dataclasses.replace(jcfg.pyramid, approx_recall=None))
    jbatch = jax_batch_to_device(both, jcfg.pyramid)
    single = jax.tree.map(lambda x: x[0], jbatch)
    jstate = jts.create_train_state(jcfg, jax.random.PRNGKey(0), single, steps_per_epoch=10)
    jmetrics, jgrads = jts.make_value_and_grad(jcfg)(jstate, jbatch, jax.random.PRNGKey(1))
    state_dict = params_from_jax(jax.tree.map(np.asarray, jstate.params))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = make_tiny_cfg()
        model = RDMNet(cfg, device="cpu")
        model.load_state_dict(state_dict, strict=True)
        names = [n for n, _ in model.named_parameters()]
        # lr x 2: what scale_lr_by_dp gives the world-2 ranks
        state = create_train_state(cfg, model, steps_per_epoch=10, dp_size=2)
        vag = make_value_and_grad(cfg, device="cpu")
        batch = batch_to_device(both, cfg.pyramid, device="cpu")
        gen = torch.Generator().manual_seed(1)
        metrics, grads = vag(state, batch, gen)
        grads = [g.clone() for g in grads]
        state.apply_gradients(grads)
        params1 = [p.detach().clone() for p in state.params]

        # two micro-batches of both pairs from the same seed: the generator's
        # state before (micro-batch m, pair r) lands at 2 m + r
        gen.manual_seed(1)
        gen_states = [gen.get_state()]

        def mark(stage):
            if stage == "backward":
                gen_states.append(gen.get_state())

        acc_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=2))
        acc_model = RDMNet(acc_cfg, device="cpu")
        acc_model.load_state_dict(state_dict, strict=True)
        acc_state = create_train_state(acc_cfg, acc_model, steps_per_epoch=10, dp_size=2)
        for _ in range(2):
            _, g = vag(acc_state, batch, gen, stage_hook=mark)
            acc_state.apply_gradients(g)
        acc_params = [p.detach().clone() for p in acc_state.params]
    finally:
        torch.set_num_threads(threads)
    return dict(pairs=pairs, state_dict=state_dict, gen_states=gen_states[:4], names=names,
                metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                params1=params1, acc_params=acc_params, acc_count=acc_state.count,
                jmetrics=jax.tree.map(float, jmetrics),
                jgrads=params_from_jax(jax.tree.map(np.asarray, jgrads)))


@pytest.fixture(scope="module")
def world2(one_process, tmp_path_factory):
    payload = {k: one_process[k] for k in ("pairs", "state_dict", "gen_states")}
    return _spawn(tmp_path_factory.mktemp("w2"), "_task_world2", 2, payload)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("w3"), "_task_world3", 3)


@pytest.fixture(scope="module")
def unsharded():
    return dict(searches={c[0]: _search(c) for c in _search_cases()},
                pyramid=_pyramid_leaves())


# ---------------------------------------------------------- the dp step

def test_ranks_import_no_jax(world2, world3):
    assert not any(r["jax_imported"] for r in world2 + world3)


def test_replicate_broadcasts_rank0_weights(world2):
    assert all(r["replicated"] for r in world2)


@pytest.mark.parametrize("name", LOSSES + ("PIR", "grad_norm"))
def test_dp_metrics_equal_one_process(world2, one_process, name):
    for r in world2:
        np.testing.assert_allclose(r["metrics"][name], one_process["metrics"][name], rtol=1e-6)


def test_dp_gradients_equal_one_process_and_across_ranks(world2, one_process):
    want = one_process["grads"]
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want)))
    for a, b in zip(world2[0]["grads"], world2[1]["grads"]):
        assert torch.equal(a, b)
    for name, got, w in zip(one_process["names"], world2[0]["grads"], want):
        assert float((got - w).abs().max()) <= 1e-6 * total, name


@pytest.mark.parametrize("name", LOSSES)
def test_dp_losses_match_jax_two_pair_step(world2, one_process, name):
    np.testing.assert_allclose(world2[0]["metrics"][name], one_process["jmetrics"][name],
                               rtol=1e-5, atol=1e-4)


def test_dp_gradients_match_jax_two_pair_step(world2, one_process):
    """The bounds of ``test_torch_port_train.py::test_parameter_gradients``.
    ``grad_norm`` is held as in ``test_torch_port_engine.py``, where these two
    pairs train: a norm moves by at most the norm of the gradients'
    difference, bound to 2e-3 of the global norm (measured 3.4e-4 here)."""
    np.testing.assert_allclose(world2[0]["metrics"]["grad_norm"],
                               one_process["jmetrics"]["grad_norm"], rtol=2e-3)
    jg = {n: v.numpy() for n, v in one_process["jgrads"].items()}
    for n in [n for n in jg if n.endswith("kernel_points")]:
        assert not jg.pop(n).any()  # stop-gradient there, buffers here
    tg = dict(zip(one_process["names"], (g.numpy() for g in world2[0]["grads"])))
    assert set(jg) == set(tg)
    total = np.sqrt(sum(float((g ** 2).sum()) for g in jg.values()))
    diff = {n: tg[n] - jg[n] for n in jg}
    assert np.sqrt(sum(float((d ** 2).sum()) for d in diff.values())) <= 2e-3 * total
    for n in jg:
        assert np.linalg.norm(diff[n]) <= 1e-2 * np.linalg.norm(jg[n]) + 1e-6 * total, n


@pytest.mark.parametrize("key", ["params1", "acc_params"])
def test_adam_step_with_lr_scaled_by_dp(world2, one_process, key):
    assert all(r["applied"] for r in world2)
    assert [r["acc_count"] for r in world2] == [one_process["acc_count"]] * 2 == [1, 1]
    for a, b in zip(world2[0][key], world2[1][key]):
        assert torch.equal(a, b)
    for name, got, want in zip(one_process["names"], world2[0][key], one_process[key]):
        assert float((got - want).abs().max()) <= 1e-7, name


# --------------------------------------------------------- sharded search

@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", [c[0] for c in _search_cases()])
def test_sharded_search_equals_unsharded(world2, world3, unsharded, world, case):
    ranks = world2 if world == 2 else world3
    want_tab, want_ov = unsharded["searches"][case]
    for r in ranks:
        tab, ov = r["searches"][case]
        assert torch.equal(tab, want_tab), (world, case)
        assert torch.equal(ov.to(torch.int32), want_ov.to(torch.int32)), (world, case, ov, want_ov)
    if case == "banded_overflow":
        assert int(want_ov) > 0  # the case exercises the summed overflow


@pytest.mark.parametrize("case", ["banded", "batched_banded"])
def test_sharded_search_equals_jax_on_a_two_device_mesh(world2, case):
    import jax
    import jax.numpy as jnp

    from rdmnet_tpu.parallel.sharded_search import sharded_radius_knn as jax_sharded

    _, q, s, q_count, band, chunk = next(c for c in _search_cases() if c[0] == case)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("sp",))
    search = jax.jit(lambda q, s, n, qc: jax_sharded(
        q, s, n, RADIUS, K, mesh=mesh, q_count=qc, cell=0.5, band_cap=band, chunk_size=chunk,
        return_overflow=True))
    qs, ss = (q, s) if q.ndim == 3 else (q[None], s[None])
    for b in range(len(qs)):
        # chunk-aligned: each of JAX's two shards holds whole chunks
        assert qs.shape[1] % (2 * chunk) == 0
        want, ov = search(jnp.asarray(qs[b]), jnp.asarray(ss[b]), jnp.int32(ss.shape[1]),
                          jnp.int32(q_count))
        tab, got_ov = world2[0]["searches"][case]
        tab = tab if q.ndim == 3 else tab[None]
        got_ov = got_ov.reshape(-1)
        np.testing.assert_array_equal(tab[b].numpy(), np.asarray(want), err_msg=case)
        assert int(got_ov[b]) == int(ov)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_pyramid_equals_unsharded(world2, world3, unsharded, world):
    """The counterpart of ``test_parallel.py::TestShardedSearch::
    test_build_pair_batch_sp_sharded_matches``."""
    for r in world2 if world == 2 else world3:
        assert r["pyramid"].keys() == unsharded["pyramid"].keys()
        for name, want in unsharded["pyramid"].items():
            assert torch.equal(r["pyramid"][name], want), name


def test_shard_rows_start_at_chunk_multiples():
    from rdmnet_tpu_torch.parallel.sharded_search import shard_rows

    assert shard_rows(402, 3, 64) == 192 and shard_rows(512, 2, 64) == 256
    assert shard_rows(1, 4, 512) == 512 and shard_rows(30720, 2, 512) == 15360
    for q, n, c in [(402, 3, 64), (21504, 2, 512), (8704, 3, 512)]:
        rows = shard_rows(q, n, c)
        assert rows % c == 0 and rows * n >= q > rows * (n - 1) - c


# ------------------------------------------------------------- 2-D layout

def test_unified_2d_layout_dp_sp(one_process, tmp_path):
    """World 4 as dp 2 x sp 2 (the counterpart of ``test_parallel.py::
    test_unified_2d_mesh_dp_sp``)."""
    payload = {k: one_process[k] for k in ("pairs", "state_dict", "gen_states")}
    ranks = _spawn(tmp_path, "_task_mesh", 4, payload)
    assert [r["mesh"] for r in ranks] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one_process["metrics"]["loss"], rtol=1e-6)
        assert r["sp_equal"] and not r["jax_imported"]


# --------------------------------------------------------------- workflow

def _write_seq(root, seq, clouds, transforms):
    from rdmnet_tpu_torch.data.datasets import SCHEMAS

    schema = SCHEMAS["kitti"]
    for i, cloud in enumerate(clouds):
        path = os.path.join(root, schema.cloud_path.format(seq=seq, frame=i))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, cloud)
    path = os.path.join(root, schema.gt_file.format(seq=seq))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(f"{i + 1} {i} " + " ".join(f"{v:.9f}" for v in tf[:3].reshape(-1))
                          for i, tf in enumerate(transforms)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The KITTI-layout root of ``test_torch_port_engine.py``: the two train
    pairs (sequences 0 and 1) of ``_pair(0)`` and ``_pair(1)``, and one
    validation pair (sequence 6), a scan against a moved copy of itself."""
    root = str(tmp_path_factory.mktemp("kitti"))
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    tf = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    for seq in (0, 1):
        rng = np.random.RandomState(seq)
        _write_seq(root, seq, [scans[0][rng.permutation(len(scans[0]))[:500], :3],
                               scans[1][rng.permutation(len(scans[1]))[:480], :3]], [tf])
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    ref = scans[0][np.random.RandomState(0).permutation(len(scans[0]))[:500], :3]
    _write_seq(root, 6, [ref, ((ref - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)],
               [motion])
    for seq in (2, 3, 4, 5, 7, 8, 9, 10):
        _write_seq(root, seq, [], [])
    return root


@pytest.fixture(scope="module")
def workflow(root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainval")
    out = str(tmp / "run")
    ranks = _spawn(tmp, "_task_trainval", 2, {"root": root, "output_dir": out})
    return dict(ranks=ranks, out=out)


def test_trainval_dp_trains_and_resumes(workflow):
    r0, r1 = workflow["ranks"]
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["epochs"] == r1["epochs"] == (1, 2) and r0["steps"] == r1["steps"] == 2
    assert r0["shard"] == (2, 0, 2, 0) and r1["shard"] == (2, 1, 2, 1)
    # lr x 2 (scale_lr_by_dp); every validation covers the one pair once
    assert r0["lr"] == r1["lr"] == pytest.approx(2 * make_tiny_cfg().optim.lr, rel=1e-12)
    assert r0["val_pairs"] == r1["val_pairs"] == [1.0, 1.0]
    for w0, w1 in zip(r0["weights"], r1["weights"]):
        assert w0.keys() == w1.keys()
        assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert not r0["jax_imported"] and not r1["jax_imported"]
    with open(os.path.join(workflow["out"], "config.json")) as f:
        assert json.load(f)["parallel"] == {"dp": 2, "scale_lr_by_dp": True}


def test_trainval_dp_rank1_writes_no_file(workflow):
    assert workflow["ranks"][1]["writes"] == []
    with open(os.path.join(workflow["out"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [(r["phase"], r["epoch"]) for r in records] == [
        ("train", 0), ("val", 0), ("train", 1), ("val", 1)]


def test_trainval_dp_shards_match_jax_loader(workflow, root):
    """Each rank's train loader yields JAX's ``PairLoader(num_hosts=2,
    host_id=rank)`` items: the Trainer's peek, then the epoch's pass."""
    from rdmnet_tpu.data.datasets import RegistrationPairDataset as JaxDataset
    from rdmnet_tpu.data.loader import PairLoader as JaxLoader

    cfg = make_tiny_cfg()
    for rank, r in enumerate(workflow["ranks"]):
        got = [items for subset, items in r["built"] if subset == "train"]
        want = []
        for _ in range(2):  # the first run, then the resumed one: fresh loaders each
            ds = JaxDataset("kitti", root, "train", point_limit=cfg.train.point_limit,
                            use_augmentation=False, seed=cfg.seed + rank)
            loader = JaxLoader(ds, cap=cfg.pyramid.caps[0], shuffle=True, drop_last=True,
                               seed=cfg.seed, num_hosts=2, host_id=rank, prefetch=0)
            for batch in [loader.peek()] + list(loader):
                want.append([(m["seq_id"], m["ref_frame"], m["src_frame"])
                             for m in batch["metadata"]])
        assert got == want, rank


def test_trainval_dp_validation_equals_one_process(workflow, root, tmp_path):
    """The last validation record against one process validating snapshot 2
    (the weights that record was taken with)."""
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset
    from rdmnet_tpu_torch.data.loader import PairLoader
    from rdmnet_tpu_torch.engine import Trainer
    from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager

    with open(os.path.join(workflow["out"], "metrics.jsonl")) as f:
        want = [json.loads(line) for line in f][-1]
    cfg = make_tiny_cfg()
    train = RegistrationPairDataset("kitti", root, "train", point_limit=cfg.train.point_limit)
    val = RegistrationPairDataset("kitti", root, "val", point_limit=cfg.train.point_limit)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = Trainer(cfg, PairLoader(train, cap=CAP), PairLoader(val, cap=CAP),
                          output_dir=str(tmp_path), device="cpu")
        params = CheckpointManager(os.path.join(workflow["out"], "snapshots")).restore_params(2)
        trainer.state.model.load_state_dict(params, strict=True)
        got = trainer.validate()
    finally:
        torch.set_num_threads(threads)
    assert set(got) == set(want) - {"phase", "epoch"}
    for k, v in got.items():
        assert abs(v - want[k]) <= 1e-6, k


# ----------------------------------------------------------------- errors

def test_dp_without_a_matching_world_raises(root, tmp_path):
    from rdmnet_tpu_torch.cli import trainval
    from rdmnet_tpu_torch.engine import Trainer

    assert not dist.is_initialized() and "WORLD_SIZE" not in os.environ
    argv = ["--root", root, "--output_dir", str(tmp_path), "--device", "cpu",
            "--cfg_preset", "tiny", "--max_epoch", "1"]
    with pytest.raises(ValueError, match="--dp 2 disagrees with the world of 1"):
        trainval.main(argv + ["--dp", "2"])
    cfg = make_tiny_cfg()
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, dp=2))
    with pytest.raises(RuntimeError, match="needs a process group"):
        Trainer(cfg, None, output_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("rank", [0, 1])
def test_nccl_ranks_without_a_card_each_raise(tmp_path, rank):
    from rdmnet_tpu_torch.parallel import initialize_distributed

    if torch.cuda.device_count() > rank:
        pytest.skip("this host has a card for the rank")
    with pytest.raises(RuntimeError, match="one card per rank"):
        initialize_distributed(backend="nccl", init_method=f"file://{tmp_path}/store",
                               world_size=2, rank=rank)
    assert not dist.is_initialized()
