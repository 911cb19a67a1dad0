"""Misc helpers (twin of ``rdmnet_tpu/utils/common.py``; reference
geotransformer/utils/common.py:46-71)."""

from __future__ import annotations

import os
import pickle
from contextlib import contextmanager
from typing import Any, Dict, Optional


def ensure_dir(path: str):
    os.makedirs(path, exist_ok=True)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_pickle(obj: Any, path: str):
    ensure_dir(os.path.dirname(os.path.abspath(path)))
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def get_log_string(result_dict: Dict, epoch: Optional[int] = None,
                   iteration: Optional[int] = None, lr: Optional[float] = None) -> str:
    """Structured metric log line (reference common.py:46-71)."""
    parts = []
    if epoch is not None:
        parts.append(f"epoch: {epoch}")
    if iteration is not None:
        parts.append(f"iter: {iteration}")
    for key, value in result_dict.items():
        try:
            parts.append(f"{key}: {float(value):.4f}")
        except (TypeError, ValueError):
            parts.append(f"{key}: {value}")
    if lr is not None:
        parts.append(f"lr: {lr:.3e}")
    return ", ".join(parts)


@contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` scope over the host and, where a card is present,
    the device; on exit a Chrome trace (``trace.json``, open it in
    chrome://tracing or Perfetto) is written into ``log_dir``. Yields the
    profiler (``key_averages()`` for sums by operator and kernel), or None
    when ``log_dir`` is None and nothing is traced."""
    if log_dir is None:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    ensure_dir(log_dir)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
