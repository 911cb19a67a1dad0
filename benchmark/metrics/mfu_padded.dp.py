"""A rank's training FLOPs a pair counted at padded rows (the reference's
products) times one card's pairs a second (all ranks' pairs over the shared
window, over the cards), over the card's float32 peak: the mean rank."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
