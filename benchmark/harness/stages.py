"""Arithmetic of the per-layer metric readers that read what the program
exposes of its own stages: the marks a captured program carries into the
device trace (empty kernels named ``rdmnet_mark_<name>``) and the spans and
counters it keeps in memory while a profile records
(``rdmnet_tpu_torch.trace.snapshot()``). The rules live here, not in the
program, so a change to the program cannot move a metric. Each returns None
where the run has nothing to read: a program without marks, or without the
trace module."""

from __future__ import annotations

from typing import List, Optional, Tuple

MARK = "rdmnet_mark_"


def _stage_s(tl, device: int, a: str, b: str, wall: bool) -> Tuple[float, int]:
    """(seconds, intervals) on ``device`` between the end of each mark ``a``
    and the start of the next mark ``b`` after it, inside the window: the
    union of the device's other intervals there, or with ``wall`` the
    interval's whole length."""
    lo, hi = tl.window
    ops = [(n, t0, t1) for n, t0, t1, d in tl.device_ops if d == device and t1 > lo and t0 < hi]
    marks = sorted((t0, t1, n[len(MARK):]) for n, t0, t1 in ops if n.startswith(MARK))
    busy: List[List[float]] = []
    for t0, t1 in sorted((t0, t1) for n, t0, t1 in ops if not n.startswith(MARK)):
        if busy and t0 <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t1)
        else:
            busy.append([t0, t1])
    total, found = 0.0, 0
    for i, (_, a_end, name) in enumerate(marks):
        if name != a:
            continue
        b_start = next((t0 for t0, _, n in marks[i + 1:] if n == b), None)
        if b_start is None:
            continue
        found += 1
        if wall:
            total += b_start - a_end
        else:
            total += sum(min(t1, b_start) - max(t0, a_end) for t0, t1 in busy
                         if t1 > a_end and t0 < b_start)
    return total, found


def stage_ms_per_call(run, a: str, b: str, wall: bool = False,
                      worst: bool = False) -> Optional[float]:
    """Device ms a traced call spends between marks ``a`` and ``b``
    (``_stage_s``), summed over the window on each rank's card and divided
    by the window's calls: the mean over the ranks, or the worst."""
    per_rank = []
    for tl in run.timelines:
        if not tl.calls:
            continue
        for device in tl.devices():
            sec, found = _stage_s(tl, device, a, b, wall)
            if found:
                per_rank.append(sec * 1e3 / tl.calls)
    if not per_rank:
        return None
    return max(per_rank) if worst else sum(per_rank) / len(per_rank)


def snapshot() -> Optional[dict]:
    """The program's spans and counters of the traced window, or None where
    the program keeps none."""
    try:
        from rdmnet_tpu_torch import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap["spans"] or snap["counters"] else None


def span_seconds(snap: dict, names) -> float:
    return sum(s.t1 - s.t0 for s in snap["spans"] if s.name in names)


def span_count(snap: dict, name: str) -> int:
    return sum(1 for s in snap["spans"] if s.name == name)


def per_request(counters: Tuple[str, ...]) -> "callable":
    """A reader: the counters' sum a served request (``serve`` span)."""
    def read(run) -> Optional[float]:
        snap = snapshot()
        if snap is None or not span_count(snap, "serve"):
            return None
        if not any(c in snap["counters"] for c in counters):
            return None
        return sum(snap["counters"].get(c, 0) for c in counters) / span_count(snap, "serve")

    return read
