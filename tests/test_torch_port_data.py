"""The port's data pipeline against the JAX package's, on the CPU: dataset
layouts and GT files, ``RegistrationPairDataset`` items, ``PairLoader``
batches, ``CycleLoader``, augmentation, and the meters.

The dataset roots are written by a fixture with the port's
``write_procedural_root`` (procedural scans, small). Everything here is
numpy on both sides, so every array is held bit for bit: same values, same
dtypes, the ``RandomState`` draws taken in the same order.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from rdmnet_tpu.data import datasets as jdatasets
from rdmnet_tpu.data import loader as jloader
from rdmnet_tpu.engine import iter_trainer as jiter
from rdmnet_tpu.engine import meters as jmeters
from rdmnet_tpu.utils import se3_np as jse3
from rdmnet_tpu_torch.data import datasets, loader
from rdmnet_tpu_torch.data.procedural import procedural_sequence
from rdmnet_tpu_torch.engine import iter_trainer, meters
from rdmnet_tpu_torch.utils import se3_np

SCAN = dict(n_rings=12, n_azimuths=150)
KITTI = {0: (21, 4), 1: (22, 3), 6: (23, 3), 8: (24, 3), 9: (25, 2)}
OTHERS = {"kitti360": {2: (31, 3)}, "apollo": {1: (32, 2)}, "mulran": {"kaist01": (33, 3)}}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    out = {"kitti": str(base / "kitti"), "kitti_b": str(base / "kitti_b")}
    datasets.write_procedural_root(out["kitti"], "kitti", KITTI, **SCAN)
    datasets.write_procedural_root(out["kitti_b"], "kitti", {0: (41, 3), 6: (42, 2)}, **SCAN)
    for name, seqs in OTHERS.items():
        out[name] = str(base / name)
        datasets.write_procedural_root(out[name], name, seqs, **SCAN)
    # the infer subset's demo clouds
    scans, _ = procedural_sequence(51, 2, **SCAN)
    demo = base / "demo"
    demo.mkdir()
    for frame, scan in zip((0, 4, 7), scans + scans[:1]):
        np.save(demo / f"{frame:06d}.npy", scan)
    out["demo"] = str(demo)
    return out


def _equal_items(got, want, where=""):
    assert set(got) == set(want), where
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")
        else:
            assert g == w, (where, k)


def _equal_batches(got, want, where=""):
    assert set(got) == set(want), where
    for k in want:
        if k == "metadata":
            assert got[k] == want[k], where
        else:
            assert got[k].dtype == want[k].dtype, (where, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")


def test_schemas_equal():
    assert set(datasets.SCHEMAS) == set(jdatasets.SCHEMAS)
    for name, schema in jdatasets.SCHEMAS.items():
        assert dataclasses.asdict(datasets.SCHEMAS[name]) == dataclasses.asdict(schema)


def test_written_root_is_the_jax_layout(roots):
    """The root writer's files are read by the JAX package's dataset."""
    ds = jdatasets.RegistrationPairDataset("kitti", roots["kitti"], "train")
    assert len(ds) == 3 + 2
    scans, poses = procedural_sequence(21, 4, **SCAN)
    item = ds[0]
    np.testing.assert_array_equal(item["ref_points"], scans[0][:, :3])
    np.testing.assert_array_equal(item["src_points"], scans[1][:, :3])
    np.testing.assert_allclose(item["transform"], np.linalg.inv(poses[0]) @ poses[1], atol=1e-6)


@pytest.mark.parametrize("layout,subset", [("kitti", "train"), ("kitti", "val"), ("kitti", "test"),
                                           ("kitti360", "test"), ("apollo", "test"),
                                           ("mulran", "test")])
def test_load_gt_pairs_and_splits_equal(roots, layout, subset):
    got = datasets.make_dataset(layout, roots[layout], subset)
    want = jdatasets.make_dataset(layout, roots[layout], subset)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _equal_items(g, w, layout)
    schema = datasets.SCHEMAS[layout]
    seq = next(iter(OTHERS.get(layout, KITTI)))
    path = f"{roots[layout]}/{schema.gt_file.format(seq=seq)}"
    for g, w in zip(datasets.load_gt_pairs(path, seq), jdatasets.load_gt_pairs(path, seq)):
        _equal_items(g, w)


DATASET_CASES = {
    "train_augmented_limited": dict(root="kitti", subset="train", point_limit=900,
                                    use_augmentation=True, augmentation_rotation=3.0, seed=5),
    "train_default_augmentation": dict(root="kitti", subset="train", use_augmentation=True),
    "val": dict(root="kitti", subset="val", point_limit=1200),
    "test": dict(root="kitti", subset="test"),
    "multi_root": dict(root="kitti,kitti_b", subset="train", point_limit=700,
                       use_augmentation=True),
    "mulran": dict(root="mulran", subset="test", dataset="mulran", point_limit=500),
    "infer": dict(root="demo", subset="infer", demo_asset_dir="demo"),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_items_equal(roots, case):
    kw = dict(DATASET_CASES[case])
    dataset = kw.pop("dataset", "kitti")
    root = ",".join(roots[r] for r in kw.pop("root").split(","))
    if "demo_asset_dir" in kw:
        kw["demo_asset_dir"] = roots[kw["demo_asset_dir"]]
    got = datasets.RegistrationPairDataset(dataset, root, **kw)
    want = jdatasets.RegistrationPairDataset(dataset, root, **kw)
    assert len(got) == len(want) > 0
    # two passes in a scrambled order: the shared RandomState advances alike
    order = list(np.random.RandomState(0).permutation(len(want))) * 2
    for i in order:
        _equal_items(got[int(i)], want[int(i)], f"{case}[{i}]")
    if case == "multi_root":
        assert {got[i]["seq_id"] for i in range(len(got))} == {"0.0", "0.1", "1.0"}


def test_augmentation_draws_equal():
    for seed in range(4):
        for factor in (1.0, 12.0):
            np.testing.assert_array_equal(
                se3_np.random_sample_rotation(np.random.RandomState(seed), factor),
                jse3.random_sample_rotation(np.random.RandomState(seed), factor))
        rng = np.random.RandomState(seed)
        ref, src = rng.rand(50, 3).astype(np.float32), rng.rand(40, 3).astype(np.float32)
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = rng.rand(3)
        got = se3_np.augment_point_cloud_pair(np.random.RandomState(seed), ref, src, tf)
        want = jse3.augment_point_cloud_pair(np.random.RandomState(seed), ref, src, tf)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    angles = np.random.RandomState(9).randn(3)
    np.testing.assert_array_equal(se3_np.euler_zyx_matrix(*angles), jse3.euler_zyx_matrix(*angles))


def _loaders(roots, subset="train", point_limit=600, augment=True, **kw):
    def make(ds_mod, ld_mod):
        ds = ds_mod.RegistrationPairDataset("kitti", roots["kitti"], subset,
                                            point_limit=point_limit, use_augmentation=augment,
                                            seed=3)
        return ld_mod.PairLoader(ds, **kw)
    return make(datasets, loader), make(jdatasets, jloader)


LOADER_CASES = {
    "plain": dict(cap=512),
    "shuffle_drop_last": dict(cap=512, batch_size=2, shuffle=True, drop_last=True, seed=11),
    "ragged_tail": dict(cap=700, batch_size=2, shuffle=True),
    "ragged_tail_batch_3": dict(cap=512, batch_size=3, prefetch=0),
    "host_0_of_3": dict(cap=512, shuffle=True, num_hosts=3, host_id=0),
    "host_2_of_3": dict(cap=512, batch_size=2, shuffle=True, num_hosts=3, host_id=2),
    "one_host_sync": dict(cap=400, batch_size=2, num_hosts=1, prefetch=0, drop_last=True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_equal(roots, case):
    got, want = _loaders(roots, **LOADER_CASES[case])
    assert len(got) == len(want) > 0
    for epoch in range(2):  # the shuffle advances from pass to pass
        g_batches, w_batches = list(got), list(want)
        assert len(g_batches) == len(w_batches) == len(want)
        for b, (g, w) in enumerate(zip(g_batches, w_batches)):
            _equal_batches(g, w, f"{case} epoch {epoch} batch {b}")
    if case.startswith("ragged"):
        assert not g_batches[-1]["batch_valid"].all() and g_batches[0]["batch_valid"].all()


def test_peek_and_iter_from_equal(roots):
    kw = dict(cap=512, batch_size=2, shuffle=True, seed=4)
    got, want = _loaders(roots, **kw)
    _equal_batches(got.peek(), want.peek(), "peek")
    for skip in (1, 2):
        g, w = list(got.iter_from(skip)), list(want.iter_from(skip))
        assert len(g) == len(w) == len(want) - skip
        for a, b in zip(g, w):
            _equal_batches(a, b, f"iter_from({skip})")


@pytest.mark.parametrize("start", [0, 2, 7])
def test_cycle_loader_resumed_mid_pass_equal(roots, start):
    got, want = _loaders(roots, cap=512, batch_size=2, shuffle=True, seed=8)
    g_stream = iter(iter_trainer.CycleLoader(got, start_iteration=start))
    w_stream = iter(jiter.CycleLoader(want, start_iteration=start))
    for i in range(7):
        _equal_batches(next(g_stream), next(w_stream), f"start {start} batch {i}")
    g_stream.close()
    w_stream.close()


class _Failing:
    def __init__(self, items, bad):
        self.items, self.bad = items, bad

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"unreadable item {i}")
        return self.items[i]


def _items(n):
    rng = np.random.RandomState(0)
    return [{"seq_id": 0, "ref_frame": i, "src_frame": i + 1,
             "ref_points": rng.rand(30, 3).astype(np.float32),
             "src_points": rng.rand(20, 3).astype(np.float32),
             "transform": np.eye(4, dtype=np.float32)} for i in range(n)]


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "PairLoader"]


def test_worker_error_reaches_the_consumer():
    ld = loader.PairLoader(_Failing(_items(5), bad=3), cap=32)
    seen = []
    with pytest.raises(OSError, match="unreadable item 3"):
        for batch in ld:
            seen.append(batch["metadata"][0]["ref_frame"])
    assert seen == [0, 1, 2]
    deadline = time.time() + 10
    while _loader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _loader_threads()


def test_abandoned_iterator_stops_its_thread():
    ld = loader.PairLoader(_Failing(_items(40), bad=-1), cap=32, prefetch=1)
    it = iter(ld)
    next(it)
    assert _loader_threads()
    it.close()
    deadline = time.time() + 10
    while _loader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _loader_threads()


@pytest.mark.parametrize("last_n", [None, 3])
def test_summary_board_equal(last_n):
    rng = np.random.RandomState(last_n or 0)
    got, want = meters.SummaryBoard(last_n), jmeters.SummaryBoard(last_n)
    for _ in range(7):
        record = {"loss": float(rng.rand()), "RR": float(rng.rand() > 0.5),
                  "PIR": np.float32(rng.rand()), "meta": "not a number"}
        got.update_from_dict(record)
        want.update_from_dict(record)
    got.update("extra", [1.0, 2.5])
    want.update("extra", [1.0, 2.5])
    assert got.summary() == want.summary() and got.format() == want.format()
    for key in ("loss", "extra"):
        g, w = got.meters[key], want.meters[key]
        assert (g.sum(), g.mean(), g.std(), g.median()) == (w.sum(), w.mean(), w.std(), w.median())
    got.reset()
    want.reset()
    assert got.summary() == want.summary()


def test_timer_equal(monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["t"])
    results = []
    for t in (meters.Timer(), jmeters.Timer()):
        clock["t"] = 0.0
        t.tic()
        for dt, op in [(0.5, "record_prepare"), (1.25, "record_process"), (0.25, "record_prepare"),
                       (2.0, "record_process"), (0.75, "record_process")]:
            clock["t"] += dt
            getattr(t, op)()
        results.append((t.prepare_time(), t.process_time(), t.last_prepare(), t.last_process()))
    assert results[0] == results[1] == (0.375, 4.0 / 3.0, 0.25, 0.75)
