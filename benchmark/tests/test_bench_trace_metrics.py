"""The readers of the program's stage marks, spans and counters
(``benchmark/metrics``, ``harness/stages.py``) on synthetic timelines and
snapshots: marker kernels left out, the interval from one mark's end to the
next mark's start, division by the window's calls, the worst rank of the
exchange, and nothing read where the program keeps nothing."""

import pytest

from benchmark.harness import cells
from benchmark.harness.record import Record
from benchmark.harness.trace import Timeline
from benchmark.tests.tiny import REPO

M = "rdmnet_mark_"


def reader(name):
    return cells.metric_reader(name, REPO / "benchmark")


def record(*timelines):
    return Record(cell="t", seed=1, seconds=1.0, trace=True, timelines=list(timelines))


def served_call(t, device=0):
    """One served call starting at ``t`` (seconds): each stage 1 ms of work,
    the encoder's two kernels overlapping by 0.5 ms, a copy out after lgr."""
    ops, at = [], t
    for name in ("begin", "build", "encoder_t1", "decoder", "vote_t2", "matching", "ot", "lgr"):
        if name == "encoder_t1":
            ops += [("gemm", at, at + 1e-3, device), ("gather", at + 0.5e-3, at + 1.5e-3, device)]
            at += 1.5e-3
        elif name != "begin":
            ops.append(("work", at, at + 1e-3, device))
            at += 1e-3
        ops.append((M + name, at, at + 1e-5, device))
        at += 1e-5
    ops.append(("Memcpy DtoH", at + 1e-4, at + 3e-4, device))
    return ops


def test_stage_readers_exclude_marks_and_divide_by_calls():
    ops = served_call(0.0) + served_call(0.1)
    tl = Timeline(window=(0.0, 1.0), device_ops=ops, calls=2)
    rec = record(tl)
    assert reader("build_ms.register")(rec) == pytest.approx(1.0)
    assert reader("encoder_t1_ms.register")(rec) == pytest.approx(1.5)
    for name in ("decoder", "vote_t2", "matching", "ot", "lgr"):
        assert reader(f"{name}_ms.register")(rec) == pytest.approx(1.0), name
    assert reader("build_ms.train")(rec) == pytest.approx(1.0)  # the same rule, any program


def test_forward_takes_the_inner_marks_in():
    ops, at = [], 0.0
    for name in ("begin", "build", "encoder_t1", "decoder", "ot", "forward", "losses",
                 "backward", "optimizer"):
        if name != "begin":
            ops.append(("work", at, at + 2e-3, 0))
            at += 2e-3
        ops.append((M + name, at, at + 1e-5, 0))
        at += 1e-5
    rec = record(Timeline(window=(0.0, 1.0), device_ops=ops, calls=1))
    assert reader("forward_ms.train")(rec) == pytest.approx(8.0, rel=1e-3)
    for name in ("build", "losses", "backward", "optimizer"):
        assert reader(f"{name}_ms.train")(rec) == pytest.approx(2.0), name


def test_exchange_is_wall_time_on_the_worst_rank():
    def rank(gap, device):
        return Timeline(window=(0.0, 1.0), calls=2, device_ops=[
            (M + "gradients", 0.0, 0.001, device), ("ncclKernel_AllReduce", 0.002, 0.003, device),
            (M + "update", 0.001 + gap, 0.002 + gap, device),
            (M + "gradients", 0.5, 0.501, device), (M + "update", 0.501 + gap, 0.502 + gap, device),
        ])

    rec = record(rank(0.004, 0), rank(0.010, 1), rank(0.006, 2))
    assert reader("exchange_ms.dp")(rec) == pytest.approx(10.0)


def test_marks_outside_the_window_and_programs_without_marks():
    ops = served_call(0.0) + served_call(0.1)
    assert reader("build_ms.register")(record(Timeline(window=(0.05, 1.0), device_ops=ops,
                                                       calls=1))) == pytest.approx(1.0)
    bare = Timeline(window=(0.0, 1.0), device_ops=[("work", 0.0, 0.5, 0)], calls=1)
    for name in ("build_ms.register", "forward_ms.train", "exchange_ms.dp"):
        assert reader(name)(record(bare)) is None
        assert reader(name)(record()) is None


def span(name, t0, t1, request, parent=None):
    from rdmnet_tpu_torch.trace import Span

    return Span(name, t0, t1, parent, request, 1)


def test_span_and_counter_readers(monkeypatch):
    from rdmnet_tpu_torch import trace

    spans = []
    for r in (1, 2):
        spans += [span("serve.pad", 0, 0.001, r, "serve"), span("serve.stage", 0, 0.002, r, "serve"),
                  span("serve.launch", 0, 0.0005, r, "serve"), span("serve.wait", 0, 0.02, r, "serve"),
                  span("serve.unpack", 0, 0.0005, r, "serve"), span("serve", 0, 0.03, r)]
    spans += [span("loader.get", 0, 0.003, 3), span("loader.get", 0, 0.001, 4)]
    counters = {"serve.bucket.21504": 2, "serve.rows": 60000, "serve.capacity_rows": 86016,
                "serve.truncated_rows": 10, "pipeline.dropped": 4, "pipeline.nms_rounds": 6,
                "loader.empty": 1}
    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": spans, "counters": counters})
    rec = record(Timeline(window=(0.0, 1.0), calls=4))
    assert reader("serve_host_ms.register")(rec) == pytest.approx(4.0)
    assert reader("nms_rounds.register")(rec) == pytest.approx(3.0)
    assert reader("dropped_points.register")(rec) == pytest.approx(7.0)
    assert reader("bucket_fill.register")(rec) == pytest.approx(100 * 60000 / 86016)
    assert reader("loader_block_ms.train")(rec) == pytest.approx(1.0)

    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": [], "counters": {}})
    for name in ("serve_host_ms.register", "nms_rounds.register", "dropped_points.register",
                 "bucket_fill.register", "loader_block_ms.train"):
        assert reader(name)(rec) is None, name


def test_readers_without_the_trace_module(monkeypatch):
    import sys

    import rdmnet_tpu_torch

    monkeypatch.delattr(rdmnet_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "rdmnet_tpu_torch.trace", None)  # the import fails
    rec = record(Timeline(window=(0.0, 1.0), calls=4))
    for name in ("serve_host_ms.register", "nms_rounds.register", "dropped_points.register",
                 "bucket_fill.register", "loader_block_ms.train"):
        assert reader(name)(rec) is None, name
