"""Device ms a traced call spends in the flat gradient, its norm, the non-finite guard and Adam of a train step:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``backward`` and ``optimizer``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "backward", "optimizer")
