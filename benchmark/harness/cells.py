"""A cell's files, found by the names in ``BENCHMARK.json``.

* ``BENCHMARK.json`` (the checkout's root): the cell's ``config``,
  ``traffic`` and chips, its end-to-end and per-layer metrics;
* the configuration's ``file`` (``benchmark/configs/<config>.json``): the
  whole config as it is run, under ``config``;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters and its
  ``driver`` (``benchmark/harness/drivers/<driver>.py``);
* ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  comparison with the reference prints;
* ``benchmark/metrics/<metric>.py``: one reader a per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

@dataclass
class Cell:
    name: str
    config_name: str
    config: dict        # the config file (source, reduced, assumed, config)
    traffic_name: str
    traffic: dict       # the traffic file
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    run_seconds: int
    bench_dir: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """Cell ``name`` of ``root/BENCHMARK.json``, its files under ``root/benchmark``."""
    bench_dir = Path(root) / "benchmark"
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits_path = bench_dir / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, w["config"], config, w["traffic"], traffic, int(w["chips"]), limits,
                e2e, per_layer, int(spec["run_seconds"]), bench_dir)


def driver(cell: Cell):
    """The traffic's driver module."""
    return importlib.import_module(f"benchmark.harness.drivers.{cell.traffic['driver']}")


def metric_reader(name: str, bench_dir: Path):
    """``read(run) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
