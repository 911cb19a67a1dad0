"""Independent streams from one ``--seed``: weights, traffic, sampling."""

from __future__ import annotations

import numpy as np

STREAMS = ("weights", "traffic", "order", "sample", "targets", "loader")


def stream(seed: int, name: str) -> int:
    """A 62-bit seed of its own for ``name``, the same for the same ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), STREAMS.index(name)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(2))


def rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream(seed, name))
