"""The port's tracing (``rdmnet_tpu_torch/trace.py``): spans and counters
recorded only inside a ``torch.profiler`` profile, the stage marks of the
served pipeline and the train step in order, ``serve``'s and
``PairLoader``'s spans and counters, and ``trace.attribute`` on a synthetic
Chrome trace. The marks' kernels run on a card only (``test_torch_port_cuda.py``
and ``chip_smoke.py`` check them there); here marks are host ranges."""

import re
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rdmnet_tpu_torch import serving, trace
from rdmnet_tpu_torch.config import make_tiny_cfg
from rdmnet_tpu_torch.data.loader import PairLoader, pad_points_np
from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.engine import TRAIN_STAGES, create_train_state
from rdmnet_tpu_torch.engine.train_step import (_update_half, batch_inputs, make_gradient_half,
                                               make_train_step, marked_build)
from rdmnet_tpu_torch.models import RDMNet, pipeline
from rdmnet_tpu_torch.models.rdmnet import STAGES
from rdmnet_tpu_torch.ops.kernels._build import CSRC_DIR, KERNELS
from trace_restarts import checked

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


def mark_names(prof):
    """The ``rdmnet.mark.*`` host ranges of a profile, in the order they started."""
    marks = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith(trace.MARK_PREFIX))
    return [name[len(trace.MARK_PREFIX):] for _, name in marks]


def tiny_pair(cap):
    ref, _, _ = procedural_pair(3, n_rings=16, n_azimuths=200)
    rng = np.random.RandomState(0)
    ref = ref[rng.permutation(len(ref))[:500], :3].astype(np.float32)
    src = (ref[:480] + np.array([0.3, 0.2, 0.0], np.float32)).astype(np.float32)
    return ref, src


# ------------------------------------------------------- spans and counters

def test_spans_and_counters_record_only_inside_a_profile():
    with trace.span("outer"):
        with trace.span("inner"):
            trace.count("things", 3)
    assert trace.snapshot() == {"spans": [], "counters": {}}
    assert not trace.recording()

    with recorded():
        assert trace.recording()
        with trace.span("a"):
            with trace.span("a.child"):
                trace.count("things", 2)
            trace.count("things")
        with trace.span("b"):
            pass
    snap = trace.snapshot()
    assert snap["counters"] == {"things": 3}
    by_name = {s.name: s for s in snap["spans"]}
    assert [s.name for s in snap["spans"]] == ["a.child", "a", "b"]
    assert by_name["a.child"].parent == "a" and by_name["a"].parent is None
    assert by_name["a.child"].request == by_name["a"].request != by_name["b"].request
    assert by_name["a"].t0 <= by_name["a.child"].t0 <= by_name["a.child"].t1 <= by_name["a"].t1
    assert {s.thread for s in snap["spans"]} == {threading.get_ident()}
    trace.reset()
    assert trace.snapshot() == {"spans": [], "counters": {}}


def test_spans_outside_a_profile_allocate_nothing():
    def calls():
        for _ in range(2000):
            with trace.span("serve.pad"):
                trace.count("serve.rows", 1)

    calls()  # warm: first-call caches
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename.endswith("trace.py")]
    assert grown == []
    assert trace.span("x") is trace.span("y")  # one shared no-op


def test_spans_from_threads_keep_their_own_parents():
    def worker(tag):
        with trace.span(f"root.{tag}"):
            with trace.span(f"leaf.{tag}"):
                pass

    with recorded():
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = trace.snapshot()["spans"]
    assert len(spans) == 8
    for s in spans:
        if s.name.startswith("leaf."):
            assert s.parent == "root." + s.name[5:]
    assert len({s.request for s in spans}) == 4


# ------------------------------------------------------------------ marks

def test_mark_kernels_are_the_stage_names():
    names = re.findall(r"^\s*X\((\w+)\)", (CSRC_DIR / "mark.cu").read_text(), re.M)
    assert len(names) == len(set(names))
    assert set(names) == {"begin", *STAGES, *TRAIN_STAGES, "gradients", "update"}
    assert "mark" in KERNELS


def test_mark_on_the_cpu_is_a_host_range_only_while_recording(monkeypatch):
    def no_launch(name, device):
        raise AssertionError("a CPU mark launched a kernel")

    monkeypatch.setattr(trace, "_launch", no_launch)
    trace.mark("begin", CPU)  # outside a profile: nothing
    with recorded() as prof:
        trace.mark("begin", CPU)
        trace.mark("build", CPU)
    assert mark_names(prof) == ["begin", "build"]


def test_pipeline_marks_its_stages_in_order():
    cfg = make_tiny_cfg()
    model = RDMNet(cfg, device=CPU)
    ref, src = tiny_pair(cfg.pyramid.caps[0])
    cap = cfg.pyramid.caps[0]
    (rp, rc), (sp, sc) = pad_points_np(ref, cap), pad_points_np(src, cap)
    with recorded() as prof:
        out = pipeline(model, rp, rc, sp, sc, device=CPU)
    assert out["estimated_transform"].shape == (4, 4)
    assert mark_names(prof) == ["begin", *STAGES]


def _static_batch(cfg):
    ref, src = tiny_pair(cfg.pyramid.caps[0])
    cap = cfg.pyramid.caps[0]
    (rp, rc), (sp, sc) = pad_points_np(ref, cap), pad_points_np(src, cap)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 3] = [-0.3, -0.2, 0.0]
    host = {"ref_points": rp[None], "ref_counts": np.array([rc]), "src_points": sp[None],
            "src_counts": np.array([sc]), "transform": tf[None]}
    return {k: torch.from_numpy(v) for k, v in batch_inputs(host).items()}


def test_train_body_marks_its_stages_in_order():
    cfg = make_tiny_cfg()
    state = create_train_state(cfg, RDMNet(cfg, device=CPU))
    step = make_train_step(cfg, CPU)
    with recorded() as prof:  # the train program's body
        _, metrics = step(state, marked_build(_static_batch(cfg), cfg.pyramid),
                          torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(metrics["loss"]))
    names = mark_names(prof)
    assert [n for n in names if n in ("begin", *TRAIN_STAGES)] == ["begin", *TRAIN_STAGES]
    # the model's own marks fall inside forward (training runs no LGR)
    assert names == ["begin", "build", *STAGES[1:-1], *TRAIN_STAGES[1:]]
    assert state.count == 1


def test_split_halves_mark_gradients_then_update():
    cfg = make_tiny_cfg()
    state = create_train_state(cfg, RDMNet(cfg, device=CPU))
    gradient_half = make_gradient_half(cfg, CPU)
    with recorded() as prof:  # the data-parallel program's two bodies
        mid = gradient_half(state, marked_build(_static_batch(cfg), cfg.pyramid),
                            torch.Generator().manual_seed(0))
        _update_half(state, mid, 1)  # a world of one: the exchange leaves the sums
    names = mark_names(prof)
    assert [n for n in names if n not in STAGES[1:]] == [
        "begin", "build", "forward", "losses", "backward", "gradients", "update", "optimizer"]
    assert state.count == 1


# ------------------------------------------------------------------ serve

def test_cpu_serve_records_its_children_and_counters(tmp_path):
    cfg = make_tiny_cfg()
    serving.export_inference(cfg, RDMNet(cfg, device=CPU), str(tmp_path), bucket_scales=(1.0,))
    serve, meta = serving.load_exported(str(tmp_path), device=CPU)
    cap = meta["cap"]
    ref, src = tiny_pair(cap)
    src = np.concatenate([src, src[: cap - len(src) + 7]])  # 7 rows past the bucket
    serve(ref, src)  # outside a profile: nothing
    assert trace.snapshot() == {"spans": [], "counters": {}}
    with recorded():
        out = serve(ref, src)
        serve(ref, src[:300])
    assert set(out) == set(serving.SERVE_OUTPUTS)
    snap = trace.snapshot()
    roots = [s for s in snap["spans"] if s.name == "serve"]
    assert len(roots) == 2 and roots[0].request != roots[1].request
    first = [s for s in snap["spans"] if s.request == roots[0].request and s.name != "serve"]
    assert [s.name for s in first] == ["serve.pad", "serve.stage", "serve.launch",
                                       "serve.wait", "serve.unpack"]
    assert all(s.parent == "serve" for s in first)
    c = snap["counters"]
    assert c[f"serve.bucket.{cap}"] == 2
    assert c["serve.rows"] == 2 * len(ref) + cap + 300
    assert c["serve.capacity_rows"] == 4 * cap
    assert c["serve.truncated_rows"] == 7
    assert c["pipeline.nms_rounds"] >= 2 and c["pipeline.dropped"] >= 0


# ----------------------------------------------------------------- loader

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        pts = np.full((5 + i, 3), float(i), np.float32)
        return {"ref_points": pts, "src_points": pts, "transform": np.eye(4, dtype=np.float32),
                "seq_id": 0, "ref_frame": i, "src_frame": i + 1}


def test_pair_loader_traces_its_gets():
    loader = PairLoader(_Items(6), cap=8, batch_size=2, prefetch=2)
    with recorded():
        batches = list(loader)
    assert len(batches) == 3
    snap = trace.snapshot()
    gets = [s for s in snap["spans"] if s.name == "loader.get"]
    assert len(gets) == 4  # three batches and the end of the pass
    assert all(s.t1 >= s.t0 for s in gets)
    assert 0 <= snap["counters"].get("loader.empty", 0) <= 4
    list(loader)  # outside a profile: nothing more
    assert len(trace.snapshot()["spans"]) == 4


# ---------------------------------------------------------------- reading

def _kernel(name, ts, dur, device=0):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"device": device}}


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def test_attribute_splits_a_synthetic_trace():
    m = trace.MARK_KERNEL
    events = [
        # one program call on card 0: begin | build 10 us | encoder 30 us (two
        # kernels overlapping by 5) | decoder 20 us, then a copy out
        _kernel(m + "begin", 100, 1), _kernel("gather", 101, 10), _kernel(m + "build", 111, 1),
        _kernel("k1", 112, 20), _kernel("k2", 127, 15), _kernel(m + "encoder_t1", 142, 1),
        _kernel("k3", 143, 20), _kernel(m + "decoder", 163, 1),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 170, "dur": 4,
         "args": {"device": 0}},
        # the next call: its begin collects the copy between the two calls
        _kernel(m + "begin", 300, 1), _kernel("gather", 301, 6), _kernel(m + "build", 307, 1),
        # host spans: the gap 174-300 falls in unpack, then pad, then serve
        _range("rdmnet.serve", 150, 160), _range("rdmnet.serve.unpack", 174, 26),
        _range("rdmnet.serve.pad", 200, 60), _range("rdmnet.mark.begin", 210, 0),
        _range("bench:serve", 160, 120),  # not the port's: no span
        {"ph": "i", "name": "instant", "ts": 0},
    ]
    stages, idle = trace.attribute(events)
    assert stages == pytest.approx({"build": 0.016, "encoder_t1": 0.030, "decoder": 0.020,
                                    "begin": 0.004})
    assert idle == pytest.approx({"serve": 0.006 + 0.040, "serve.unpack": 0.026,
                                  "serve.pad": 0.060})
    # fewer boundaries: encoder_t1 falls inside decoder's stage
    stages, _ = trace.attribute(events, marks=("begin", "build", "decoder"))
    assert stages == pytest.approx({"build": 0.016, "decoder": 0.050, "begin": 0.004})
    # one window of the trace (the second call): the events inside it
    stages, idle = trace.attribute([e for e in events if 290 <= e.get("ts", 0) < 400])
    assert stages == pytest.approx({"build": 0.006}) and idle == {}


def test_attribute_reads_each_card_apart():
    m = trace.MARK_KERNEL
    events = [_kernel(m + "gradients", 0, 1, 0), _kernel("nccl", 3, 4, 0),
              _kernel(m + "update", 10, 1, 0),
              _kernel(m + "gradients", 0, 2, 1), _kernel("nccl", 5, 1, 1),
              _kernel(m + "update", 20, 1, 1)]
    stages, idle = trace.attribute(events)
    assert stages == pytest.approx({"update": 0.005})
    assert idle == pytest.approx({"outside": 0.001 + 0.003 + 0.009})


# ------------------------------------------------- profiles stopped inside spans

def test_a_profile_restarted_inside_a_span_leaves_it_out_of_the_next():
    first, second = recorded(), recorded()
    first.__enter__()
    with trace.span("outer"):
        first.__exit__(None, None, None)
        second.__enter__()
        with trace.span("inner"):
            pass
    second.__exit__(None, None, None)
    with recorded() as third:  # the range left open ends before this one records
        pass
    assert "rdmnet.outer" in {e.name for e in first.events()}
    assert {e.name for e in second.events() if e.name.startswith(trace.SPAN_PREFIX)} == {
        "rdmnet.inner"}
    assert not [e for e in third.events() if e.name.startswith(trace.SPAN_PREFIX)]
    assert [s.name for s in trace.snapshot()["spans"]] == ["inner", "outer"]


def test_profiles_stopped_inside_spans_leave_the_heap_whole(tmp_path):
    done = checked("cpu", str(tmp_path))
    assert done.returncode == 0 and done.stdout.split()[-1:] == ["ok"], done.stderr[-3000:]
