"""What one run records: the drivers fill it, the metric readers and the
result line read it."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.harness.trace import Timeline


@dataclass
class Record:
    cell: str
    seed: int
    seconds: float
    trace: bool
    setup_s: Optional[float] = None
    window_s: Optional[float] = None     # the measured window, host clock
    attempted: int = 0                   # requests sent or steps issued in the window
    failed: int = 0
    items: int = 0                       # pairs served or stepped in the window (all ranks)
    loader_wait_s: List[float] = field(default_factory=list)   # per step (worst rank in dp)
    e2e: Dict[str, float] = field(default_factory=dict)        # end-to-end metrics by name
    timelines: List[Timeline] = field(default_factory=list)    # one a rank, traced runs only
    flops_per_item: Optional[float] = None   # the reference's FLOPs a pair, counts/flops.py
    bounds_ms: Dict[str, float] = field(default_factory=dict)  # kernel bound ms a pair, counts/
    checks: Dict[str, float] = field(default_factory=dict)     # numbers compared with the reference
    memory_peak_bytes: int = 0
    device_count: int = 1
    forbidden: List[str] = field(default_factory=list)  # what other processes of the run loaded

    @property
    def timeline(self) -> Optional[Timeline]:
        return self.timelines[0] if self.timelines else None


def note(what: str, t_start: float) -> None:
    """A set-up or check phase's end on standard error, seconds since the start."""
    print(f"[{time.perf_counter() - t_start:9.3f} s] {what}", file=sys.stderr, flush=True)
