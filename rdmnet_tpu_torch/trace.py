"""Stage marks, host spans and counters of the port, recorded while a
``torch.profiler`` profile records. The active profiler is the one switch:
outside a profile a span or a counter costs one boolean check and allocates
nothing, and a mark does nothing unless a CUDA graph is being captured.

* ``mark(name, device)``: a stage boundary. While a CUDA graph is captured it
  launches the empty kernel ``rdmnet_mark_<name>`` (``csrc/mark.cu``), so every
  replay of the graph carries its stage boundaries into the device trace,
  named, on the profiler's clock; a graph captured from one stream runs them
  in the order the code placed them. Eagerly while recording: the same kernel
  on a card, a zero-length host range ``rdmnet.mark.<name>`` on the CPU.
  Marks: ``begin`` at the entry of every captured body, the model's
  ``STAGES`` after each stage, the train step's ``TRAIN_STAGES``, and in the
  data-parallel step ``gradients`` (the gradient half's end) and ``update``
  (the update half's start). Call sites call ``trace.mark`` through this
  module, so a test can replace it.
* ``span(name)``: a host range ``rdmnet.<name>`` (``record_function``, on the
  profiler's clock) and a ``Span`` kept in memory: name, start and end
  (``time.perf_counter`` seconds), the parent span's name, a request id (a
  root span draws a new one, its children share it) and the thread.
  A profile may stop, or stop and start again, inside a span: a range is
  ended only under the profile that opened it, or else as the next profile
  starts, before it records (``_on_profile_start``). Ended under a later
  profile, the range would write its end into the stopped profile's freed
  records.
* ``count(name, n)``: adds ``n`` to an in-memory counter.
* ``snapshot()`` / ``reset()``: read and clear the spans and counters.
* ``attribute(events)``: an operator's reading of a profile's Chrome trace:
  device ms by stage from the marks, and the idle gaps by the innermost
  ``rdmnet.*`` host span open across them. To read one window of a trace,
  pass the events inside it.

Profile a served request or a train step with ``torch.profiler.profile``
(CPU and CUDA activities), then read ``trace.snapshot()`` for the spans and
counters, and ``trace.attribute`` on the exported Chrome trace for the
stages and idle gaps (``README.md``, "Tracing").
"""

from __future__ import annotations

import functools
import itertools
import json
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _profiler

SPAN_PREFIX = "rdmnet."
MARK_PREFIX = "rdmnet.mark."
MARK_KERNEL = "rdmnet_mark_"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    parent: Optional[str]
    request: int
    thread: int


_lock = threading.Lock()
_spans: List[Span] = []
_counters: Dict[str, float] = {}
_requests = itertools.count(1)
_local = threading.local()
_session = 0  # profiles started in this process (``_on_profile_start``)
_orphans: list = []  # ranges whose profile stopped inside them, to end before the next records


def recording() -> bool:
    """True while a ``torch.profiler`` profile records."""
    return _profiler._is_profiler_enabled


def _on_profile_start(start=_profiler._run_on_profiler_start):
    """torch's hook, run as a profile starts and before it records, wrapped:
    counts the profile, then ends the ranges that a stopped profile left open
    while no profile records on this thread, where ending them touches no
    profile's records."""

    def run():
        global _session
        with _lock:
            _session += 1
            left = list(_orphans)
            _orphans.clear()
        for rf in left:
            rf.__exit__(None, None, None)
        start()

    return run


_profiler._run_on_profiler_start = _on_profile_start()


# ------------------------------------------------------------------ marks

@functools.lru_cache(maxsize=None)
def _marks():
    """(the launch function, {name: index}) of ``csrc/mark.cu``, built and
    loaded at first use."""
    import ctypes

    from rdmnet_tpu_torch.ops.kernels._build import load_library

    lib = load_library("mark")
    lib.rdmnet_mark_name.restype = ctypes.c_char_p
    lib.rdmnet_mark_name.argtypes = [ctypes.c_int]
    index = {lib.rdmnet_mark_name(i).decode(): i for i in range(lib.rdmnet_mark_count())}
    fn = lib.rdmnet_mark_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.rdmnet_mark_load()
    if err:
        raise RuntimeError(f"trace: loading the mark kernels failed with cudaError_t {err}")
    return fn, index


def _launch(name: str, device: torch.device) -> None:
    from rdmnet_tpu_torch.ops.kernels._build import check, launch

    fn, index = _marks()
    check(launch(fn, device, index[name]), f"mark {name}")


def ready(device) -> None:
    """Build and load the mark kernels before a capture on ``device`` (a
    module must not load lazily inside a stream capture)."""
    if torch.device(device).type == "cuda":
        _marks()


def mark(name: str, device: torch.device) -> None:
    """Stage boundary ``name`` of work on ``device`` (module docstring)."""
    if _profiler._is_profiler_enabled:
        if device.type == "cuda":
            _launch(name, device)
        else:
            with _lock, torch.profiler.record_function(MARK_PREFIX + name):
                pass
    elif device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        _launch(name, device)


# ------------------------------------------------------- spans and counters

class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Range:
    __slots__ = ("name", "parent", "request", "rf", "session", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.request = self.parent.request if self.parent is not None else next(_requests)
        stack.append(self)
        self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
        with _lock:  # a profile starting on another thread waits: the range is of ``session``
            self.session = _session
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _stack().pop()
        span = Span(self.name, self.t0, t1,
                    self.parent.name if self.parent is not None else None, self.request,
                    threading.get_ident())
        with _lock:
            _spans.append(span)
            if self.session == _session:
                self.rf.__exit__(*exc)
            else:  # another profile started inside it
                _orphans.append(self.rf)
        return False


def span(name: str):
    """A host span ``name`` (module docstring); a shared no-op outside a profile."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Range(name)


def count(name: str, n: float = 1) -> None:
    """Adds ``n`` to counter ``name`` while a profile records."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """{"spans": [Span, ...] in the order they ended, "counters": {name: value}}."""
    with _lock:
        return {"spans": list(_spans), "counters": dict(_counters)}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


# --------------------------------------------------------------- reading

def _merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _clipped(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    return sum(min(b, hi) - max(a, lo) for a, b in intervals if b > lo and a < hi)


def load_events(path: str) -> list:
    """The events of a Chrome trace file (``prof.export_chrome_trace``)."""
    with open(path) as f:
        events = json.load(f)
    return events["traceEvents"] if isinstance(events, dict) else events


def attribute(events: Sequence[dict], marks: Optional[Sequence[str]] = None
              ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Read a ``torch.profiler`` Chrome trace's events (``load_events``):

    * device ms by stage: on each card, the union of its kernel, copy and set
      intervals (the marks' own kernels left out) between the end of one mark
      and the start of the next, summed under the later mark's name. With
      ``marks`` only those marks bound the stages and the others fall inside
      them (``("begin", *TRAIN_STAGES)`` gives ``forward`` the model's stages).
      ``begin`` collects the device work between one program's last mark and
      the next one's entry (the copies between calls). Work before a card's
      first mark is left out. Divide by the calls profiled for ms a call.
    * idle ms by host span: the time with nothing on any card, between the
      first and the last device interval, split at the ``rdmnet.*`` spans'
      edges and summed by the innermost span open across each piece
      ("outside" where none is).
    """
    device: Dict[int, List[Tuple[float, float]]] = {}
    mark_at: Dict[int, List[Tuple[float, float, str]]] = {}
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"]) * 1e-3  # ms
        t1 = t0 + float(e["dur"]) * 1e-3
        name, cat = str(e.get("name", "")), e.get("cat", "")
        if cat in DEVICE_CATS:
            dev = int((e.get("args") or {}).get("device", 0))
            if name.startswith(MARK_KERNEL):
                mark_at.setdefault(dev, []).append((t0, t1, name[len(MARK_KERNEL):]))
            else:
                device.setdefault(dev, []).append((t0, t1))
        elif (cat == "user_annotation" and name.startswith(SPAN_PREFIX)
              and not name.startswith(MARK_PREFIX)):
            spans.append((t0, t1, name[len(SPAN_PREFIX):]))
    stages: Dict[str, float] = {}
    for dev, found in mark_at.items():
        busy = _merge(device.get(dev, []))
        found = sorted(m for m in found if marks is None or m[2] in marks)
        for (_, a_end, _), (b_start, _, b_name) in zip(found, found[1:]):
            stages[b_name] = stages.get(b_name, 0.0) + _clipped(busy, a_end, b_start)

    busy_all = _merge([iv for ivs in device.values() for iv in ivs]
                      + [(a, b) for m in mark_at.values() for a, b, _ in m])
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(busy_all, busy_all[1:])]
    idle: Dict[str, float] = {}
    bounds = sorted({t for a, b, _ in spans for t in (a, b)})
    for lo, hi in gaps:
        points = [lo] + [t for t in bounds if lo < t < hi] + [hi]
        for a, b in zip(points, points[1:]):
            mid = 0.5 * (a + b)
            inner = [(s1 - s0, n) for s0, s1, n in spans if s0 <= mid <= s1]
            label = min(inner)[1] if inner else "outside"
            idle[label] = idle.get(label, 0.0) + (b - a)
    return stages, idle
