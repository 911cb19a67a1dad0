"""Device ms a traced call spends in the patches and the Sinkhorn optimal transport of a served pair:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``matching`` and ``ot``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "matching", "ot")
