"""Device ms a traced call spends in the training forward of a train step (the model's own stage marks fall inside):
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``build`` and ``forward``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "build", "forward")
