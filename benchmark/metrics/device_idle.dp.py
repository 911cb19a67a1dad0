"""The worst rank's share of its traced sub-window with nothing on its card."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run, worst=True)
