"""Mean host time a window's step waits in ``next()`` on the PairLoader."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run.loader_wait_s)
