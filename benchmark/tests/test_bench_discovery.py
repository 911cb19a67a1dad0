"""A new cell, configuration, traffic mix and per-layer metric are found
from files alone: added to a copy of the benchmark, no existing file edited."""

import json

import pytest

from benchmark.harness import cells
from benchmark.harness.record import Record
from benchmark.tests.tiny import REPO, make_checkout


def test_every_cell_of_the_benchmark_loads():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = cells.load_cell(REPO, w["name"])
        assert cell.chips == w["chips"] and cell.traffic["driver"]
        assert cells.driver(cell).run and cells.driver(cell).check
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"], cell.bench_dir))
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.limits, f"{w['name']} has no limits file"


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    root = make_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    (bench / "traffic" / "long-steps.json").write_text(json.dumps(
        {"driver": "register", "bucket_scales": [1.0], "sequences": 2, "frames": 2,
         "n_rings": 16, "n_azimuths": 100, "step": 20.0, "enrich": True,
         "warmup_requests": 1, "trace_requests": 1, "check_requests": 1}))
    (bench / "metrics" / "window_share.register.py").write_text(
        "def read(run):\n    return None if not run.window_s else 100.0\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.long", "config": "tiny", "traffic": "long-steps",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "window_share.register", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "device", "moves": "pairs_per_s",
                              "workloads": ["tiny.long"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "tiny.register" in m["workloads"]:
            m["workloads"].append("tiny.long")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "limits" / "tiny.long.json").write_text("{}")
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed
    cell = cells.load_cell(root, "tiny.long")
    assert cell.traffic["step"] == 20.0 and cell.config_name == "tiny"
    assert [m["name"] for m in cell.per_layer] == ["window_share.register"]
    reader = cells.metric_reader("window_share.register", cell.bench_dir)
    rec = Record(cell="tiny.long", seed=1, seconds=1.0, trace=True, window_s=2.0)
    assert reader(rec) == 100.0
    assert reader(Record(cell="tiny.long", seed=1, seconds=1.0, trace=True)) is None


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell(REPO, "no.such.cell")
