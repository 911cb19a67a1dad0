"""Device ms a traced call spends in the vote layer, NMS and the second ThDRoFormer of a served pair:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``decoder`` and ``vote_t2``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "decoder", "vote_t2")
