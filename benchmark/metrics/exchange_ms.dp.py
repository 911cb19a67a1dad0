"""Wall ms on the card a traced step spends between the gradient half's
last mark ``gradients`` and the update half's first mark ``update``: the
all-reduces and the host between the two graphs, idle time included; the
worst rank."""

from benchmark.harness.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, "gradients", "update", wall=True, worst=True)
