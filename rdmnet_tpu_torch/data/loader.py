"""Host-side pair loader: capacity bucketing, padding, batching, the
per-host shard and a prefetch thread (own copy of
``rdmnet_tpu/data/loader.py``).

The loader does numpy work only: padding and batching. Batches reach the
device on the consumer's thread (``engine.trainer.batch_to_device``), where
the pyramid is built; the prefetch thread never touches CUDA.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


def choose_bucket(num_points: int, bucket_caps: Sequence[int]) -> int:
    """Index of the smallest bucket whose level-0 capacity fits
    ``num_points`` (the largest if none does). ``bucket_caps`` ascending."""
    for i, cap in enumerate(bucket_caps):
        if num_points <= cap:
            return i
    return len(bucket_caps) - 1


def pad_points_np(points: np.ndarray, cap: int, pad_coord: float = 1.0e9):
    """(cap, 3) float32 holding the first ``cap`` points, padded with
    ``pad_coord``; and the valid count as int32."""
    n = min(len(points), cap)
    out = np.full((cap, 3), pad_coord, np.float32)
    out[:n] = points[:n]
    return out, np.int32(n)


class PairLoader:
    """Yields numpy batches: ``ref_points``/``src_points`` (B, cap, 3) padded,
    ``ref_counts``/``src_counts``, ``ref_dropped``/``src_dropped`` (points
    beyond ``cap``), ``transform`` (B, 4, 4), ``metadata`` and
    ``batch_valid`` (B,) bool, False for the repeats that fill a ragged tail.

    ``shuffle`` draws one permutation per pass from a ``RandomState(seed)``
    that lives as long as the loader. With ``num_hosts`` > 1 the order is
    padded (its head repeated) to a multiple of ``num_hosts`` and host
    ``host_id`` takes every ``num_hosts``-th item from ``host_id``, so every
    host yields the same number of batches. ``prefetch`` > 0 loads batches
    on a thread, at most ``prefetch`` ahead."""

    def __init__(self, dataset, cap: int, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 7351, num_hosts: int = 1,
                 host_id: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.cap = cap
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.prefetch = prefetch

    def __len__(self):
        n = -(-len(self.dataset) // self.num_hosts)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        per_host = -(-len(idx) // self.num_hosts)
        total = per_host * self.num_hosts
        if total > len(idx):
            idx = np.concatenate([idx, idx[: total - len(idx)]])
        return idx[self.host_id:: self.num_hosts]

    def repeated(self, batch: int) -> np.ndarray:
        """(batch_size,) bool: the rows of this host's batch ``batch`` that
        repeat an item to fill the hosts' shards to one length (the padded
        order's head). Under one host, none."""
        pos = self.host_id + self.num_hosts * (batch * self.batch_size
                                               + np.arange(self.batch_size))
        return pos >= len(self.dataset)

    def _make_batch(self, items) -> dict:
        ref = [pad_points_np(it["ref_points"], self.cap) for it in items]
        src = [pad_points_np(it["src_points"], self.cap) for it in items]
        return {
            "ref_points": np.stack([p for p, _ in ref]),
            "ref_counts": np.stack([c for _, c in ref]),
            "src_points": np.stack([p for p, _ in src]),
            "src_counts": np.stack([c for _, c in src]),
            "ref_dropped": np.stack([np.int32(max(0, len(it["ref_points"]) - self.cap))
                                     for it in items]),
            "src_dropped": np.stack([np.int32(max(0, len(it["src_points"]) - self.cap))
                                     for it in items]),
            "transform": np.stack([it["transform"] for it in items]),
            "metadata": [{"seq_id": it["seq_id"], "ref_frame": it["ref_frame"],
                          "src_frame": it["src_frame"]} for it in items],
        }

    def _iter_sync(self, skip_batches: int = 0) -> Iterator[dict]:
        indices = self._indices()
        nb = (len(indices) // self.batch_size if self.drop_last
              else -(-len(indices) // self.batch_size))
        for b in range(skip_batches, nb):
            chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in chunk]
            n_real = len(items)
            while len(items) < self.batch_size:
                items.append(items[-1])
            batch = self._make_batch(items)
            batch["batch_valid"] = np.arange(self.batch_size) < n_real
            yield batch

    def peek(self) -> dict:
        """The first batch, loaded on the caller's thread. It draws a
        shuffle and items as a pass does."""
        return next(self._iter_sync())

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, skip_batches: int = 0) -> Iterator[dict]:
        """A pass starting at batch ``skip_batches`` (skipped items are never
        loaded). A worker's error is raised in the consumer; a consumer that
        abandons the iterator stops the worker."""
        if self.prefetch <= 0:
            yield from self._iter_sync(skip_batches)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._iter_sync(skip_batches):
                    if not put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                put(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=worker, daemon=True, name="PairLoader")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
