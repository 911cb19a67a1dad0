"""Percent of the served buckets' rows that hold points (the rest is
padding), from the program's counters."""

from benchmark.harness.stages import snapshot


def read(run):
    snap = snapshot()
    if snap is None or not snap["counters"].get("serve.capacity_rows"):
        return None
    c = snap["counters"]
    return 100.0 * c.get("serve.rows", 0) / c["serve.capacity_rows"]
