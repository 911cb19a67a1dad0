"""The traced sub-window: ``torch.profiler`` over a few steady calls, read
back from its Chrome trace as device intervals and the benchmark's host
spans on one clock.

Host spans are ``torch.profiler.record_function("bench:<name>")`` ranges the
drivers open around their calls into the program (``span``); the trace's
``user_annotation`` events carry them. Busy time is the union of the
device's kernel, copy and set intervals, so streams that overlap count once."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench:"
WINDOW = SPAN_PREFIX + "window"


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own (a no-op outside a profiler)."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Timeline:
    """One traced sub-window. Times in seconds on the profiler's clock."""

    window: Tuple[float, float]
    # name, t0, t1, device
    device_ops: List[Tuple[str, float, float, int]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)           # name, t0, t1
    calls: int = 0  # the calls of the program inside the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def intervals(self, device: Optional[int] = None) -> List[Tuple[float, float]]:
        """Merged device intervals clipped to the window."""
        lo, hi = self.window
        iv = sorted((max(a, lo), min(b, hi)) for _, a, b, d in self.device_ops
                    if (device is None or d == device) and b > lo and a < hi)
        merged: List[List[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def devices(self) -> List[int]:
        return sorted({d for *_, d in self.device_ops})

    def busy_s(self, device: Optional[int] = None) -> float:
        return sum(b - a for a, b in self.intervals(device))

    def op_seconds(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name ``match`` accepts
        (summed, inside the window)."""
        lo, hi = self.window
        return sum(min(b, hi) - max(a, lo) for n, a, b, _ in self.device_ops
                   if match(n) and b > lo and a < hi)

    def top_ops(self, n: int = 10) -> List[List]:
        totals: Dict[str, float] = {}
        lo, hi = self.window
        for name, a, b, _ in self.device_ops:
            if b > lo and a < hi:
                totals[name] = totals.get(name, 0.0) + min(b, hi) - max(a, lo)
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, device: Optional[int] = None) -> List[List]:
        """Idle seconds of the window summed by the innermost host span open
        at each gap's middle ("outside" where none is), the largest first."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.intervals(device) for t in iv] + [hi]
        totals: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            inside = [(s1 - s0, name) for name, s0, s1 in self.spans
                      if s0 <= mid <= s1 and name != WINDOW]
            label = min(inside)[1][len(SPAN_PREFIX):] if inside else "outside"
            totals[label] = totals.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def read_chrome_trace(path: str) -> Timeline:
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    ops, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev = (e.get("args") or {}).get("device", 0)
            ops.append((e.get("name", "?"), t0, t1, int(dev)))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX):
            spans.append((e["name"], t0, t1))
            if e["name"] == WINDOW:
                window = (t0, t1)
    if window is None:
        raise RuntimeError("trace: the window's span is not in the trace")
    return Timeline(window=window, device_ops=ops, spans=spans)


def trace_calls(call: Callable[[int], None], n_calls: int, sync: Callable[[], None]) -> Timeline:
    """``call(i)`` for i < ``n_calls`` under the profiler, inside one window
    span that ends after ``sync()``; the trace is written to a temporary
    file, read back and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(n_calls):
                call(i)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        timeline = read_chrome_trace(path)
    finally:
        os.remove(path)
    timeline.calls = n_calls
    return timeline
