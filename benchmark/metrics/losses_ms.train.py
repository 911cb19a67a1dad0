"""Device ms a traced call spends in the losses and PIR of a train step:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``forward`` and ``losses``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "forward", "losses")
