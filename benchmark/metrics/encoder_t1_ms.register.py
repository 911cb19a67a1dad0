"""Device ms a traced call spends in the KPConv encoder, the first ThDRoFormer and the node scores of a served pair:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``build`` and ``encoder_t1``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "build", "encoder_t1")
