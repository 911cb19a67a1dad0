"""Device ms a traced call spends in the KPConv decoder of a served pair:
the union of the card's intervals (the marks' own kernels left out) between
the program's marks ``encoder_t1`` and ``decoder``, over the window's calls."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "encoder_t1", "decoder")
