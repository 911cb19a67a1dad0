"""A served pair's model FLOPs counted at the bucket's padded capacities
(the reference's products over every padded row, not only the valid ones)
times the window's pairs a second, over the card's float32 peak."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
