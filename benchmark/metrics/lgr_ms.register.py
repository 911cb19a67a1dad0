"""Device ms a traced call spends in local-to-global registration (the pose) of a served pair:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``ot`` and ``lgr``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "ot", "lgr")
