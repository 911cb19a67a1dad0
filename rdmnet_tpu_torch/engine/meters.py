"""Metric meters and timers (own copy of ``rdmnet_tpu/engine/meters.py``;
reference geotransformer/utils/{average_meter.py,summary_board.py,timer.py})."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def to_floats(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors (on any device) -> floats, with one copy to the host."""
    values = torch.stack([torch.as_tensor(v).float().reshape(()) for v in metrics.values()])
    return dict(zip(metrics, values.tolist()))


class AverageMeter:
    def __init__(self, last_n: Optional[int] = None):
        self._records = []
        self.last_n = last_n

    def update(self, value):
        # float() every element: a stored device tensor would keep its
        # memory and defer a device sync into sum()/mean()
        if isinstance(value, (list, tuple)):
            self._records += [float(v) for v in value]
        else:
            self._records.append(float(value))

    @property
    def records(self):
        if self.last_n is not None:
            return self._records[-self.last_n :]
        return self._records

    def sum(self):
        return float(np.sum(self.records)) if self.records else 0.0

    def mean(self):
        return float(np.mean(self.records)) if self.records else 0.0

    def std(self):
        return float(np.std(self.records)) if self.records else 0.0

    def median(self):
        return float(np.median(self.records)) if self.records else 0.0

    def reset(self):
        self._records = []


class SummaryBoard:
    """Adaptive dict of AverageMeters (reference summary_board.py:78-164)."""

    def __init__(self, last_n: Optional[int] = None):
        self.meters: Dict[str, AverageMeter] = defaultdict(
            lambda: AverageMeter(last_n)
        )

    def update(self, key: str, value):
        self.meters[key].update(value)

    def update_from_dict(self, d: Dict):
        for k, v in d.items():
            try:
                self.update(k, float(v))
            except (TypeError, ValueError):
                pass

    def mean(self, key: str) -> float:
        return self.meters[key].mean()

    def summary(self) -> Dict[str, float]:
        return {k: m.mean() for k, m in self.meters.items()}

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def format(self) -> str:
        return ", ".join(f"{k}: {v:.4f}" for k, v in sorted(self.summary().items()))


class Timer:
    """prepare/process split timer (reference timer.py:203-244)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._prepare_total = 0.0
        self._process_total = 0.0
        self._prepare_count = 0
        self._process_count = 0
        self._prepare_last = 0.0
        self._process_last = 0.0
        self._last = time.perf_counter()

    def tic(self):
        self._last = time.perf_counter()

    def record_prepare(self):
        now = time.perf_counter()
        self._prepare_last = now - self._last
        self._prepare_total += self._prepare_last
        self._prepare_count += 1
        self._last = now

    def record_process(self):
        now = time.perf_counter()
        self._process_last = now - self._last
        self._process_total += self._process_last
        self._process_count += 1
        self._last = now

    # last-interval readouts: the cumulative means below fold the first
    # call's warm-up into every later display
    def last_prepare(self) -> float:
        return self._prepare_last

    def last_process(self) -> float:
        return self._process_last

    def prepare_time(self) -> float:
        return self._prepare_total / max(self._prepare_count, 1)

    def process_time(self) -> float:
        return self._process_total / max(self._process_count, 1)
