"""A training step's FLOPs counted at the train capacity's padded rows (the
forward and backward products of the reference's first step, nothing
recomputed) times the window's steps a second, over the card's float32 peak."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
