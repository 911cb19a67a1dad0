"""Host ms a traced step blocks in the PairLoader's queue (the program's
``loader.get`` spans), over the window's steps."""

from benchmark.harness.stages import snapshot, span_seconds


def read(run):
    snap = snapshot()
    tl = run.timeline
    if snap is None or tl is None or not tl.calls:
        return None
    if not any(s.name == "loader.get" for s in snap["spans"]):
        return None
    return 1e3 * span_seconds(snap, ("loader.get",)) / tl.calls
