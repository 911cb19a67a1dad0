"""The card: refusal without one, its name and power limit, the result's
``device`` field."""

from __future__ import annotations

import subprocess
import sys


def require_cards(n: int) -> None:
    """Exit with code 2 and no result when fewer than ``n`` CUDA cards are
    present: the benchmark measures the card and never falls back."""
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is false); "
              "nothing is measured on the CPU", file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < n:
        print(f"benchmark: the cell needs {n} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        sys.exit(2)


def describe_cards() -> str:
    """``nvidia-smi``'s name, power limit and clocks of each card, one line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return " | ".join(line.strip() for line in out.stdout.splitlines() if line.strip()) \
            or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def device_field(count: int, memory_peak_bytes: int) -> dict:
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}
