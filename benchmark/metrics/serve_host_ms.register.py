"""Host ms a served request spends in ``serve``'s own phases, from the
program's spans: padding, staging into the pinned buffers, the launches
(copies in, the replay, the fetch's copies) and the unpacking; the wait for
the card left out. The spans are read under the profiler, whose device
tracing (CUPTI) adds host time to every kernel a graph launch enqueues:
``serve.launch`` grows with the pipeline's kernel count, so fusing kernels
lowers this metric with the host's own work unchanged. A gain in the host
path is shown against untraced requests too (PERF.md)."""

from benchmark.harness.stages import snapshot, span_count, span_seconds

PHASES = ("serve.pad", "serve.stage", "serve.launch", "serve.unpack")


def read(run):
    snap = snapshot()
    if snap is None or not span_count(snap, "serve"):
        return None
    return 1e3 * span_seconds(snap, PHASES) / span_count(snap, "serve")
