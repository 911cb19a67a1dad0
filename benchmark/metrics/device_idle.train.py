"""Share of the traced sub-window of train steps with nothing on the card."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run)
