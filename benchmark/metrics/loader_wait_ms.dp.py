"""Mean host time a step of the worst rank waits in ``next()`` on its PairLoader shard."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run.loader_wait_s)
