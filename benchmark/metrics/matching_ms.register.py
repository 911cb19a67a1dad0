"""Device ms a traced call spends in the point-to-node partition and superpoint matching of a served pair:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``vote_t2`` and ``matching``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "vote_t2", "matching")
