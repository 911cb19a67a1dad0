"""A checkout of the benchmark with one tiny cell a kind, for the CPU tests:
the port's tiny config (``make_tiny_cfg``), scans of 16 rings x 200
azimuths, a few requests and steps."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_REGISTER = {"driver": "register", "bucket_scales": [1.0], "sequences": 1, "frames": 3,
                 "n_rings": 16, "n_azimuths": 200, "step": 10.0, "enrich": False,
                 "warmup_requests": 1, "trace_requests": 2, "check_requests": 2}
TINY_DP = {"driver": "train_dp", "world": 4, "bucket_scale": 1.0, "dataset": "kitti",
           "sequences": 1, "frames": 9, "n_rings": 16, "n_azimuths": 200, "step": 10.0,
           "enrich": False, "batch_size": 1, "prefetch": 2, "warmup_steps": 1,
           "trace_steps": 2, "check_steps": 3}
TINY_TRAIN = {"driver": "train", "bucket_scale": 1.0, "dataset": "kitti", "sequences": 1,
              "frames": 4, "n_rings": 16, "n_azimuths": 200, "step": 10.0, "enrich": False,
              "batch_size": 1, "prefetch": 2, "warmup_steps": 1, "trace_steps": 2,
              "check_steps": 3}


def tiny_config() -> dict:
    from rdmnet_tpu_torch.config import make_tiny_cfg

    cfg = make_tiny_cfg()
    # a 200-azimuth scan holds ~600 points: the tiny capacities with room
    cfg = dataclasses.replace(cfg, pyramid=dataclasses.replace(
        cfg.pyramid, caps=(1024, 512, 256, 128, 64)), train=dataclasses.replace(
        cfg.train, point_limit=1000))
    return {"name": "tiny", "source": "the port's make_tiny_cfg()", "reduced": [],
            "assumed": {}, "config": dataclasses.asdict(cfg)}


def make_checkout(dest: Path, limits: dict = None) -> Path:
    """``dest`` holding a copy of ``benchmark/`` and a BENCHMARK.json of the
    tiny cells ``tiny.register`` and ``tiny.train``."""
    dest = Path(dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = dest / "benchmark"
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (bench / "traffic" / "tiny-register.json").write_text(json.dumps(TINY_REGISTER))
    (bench / "traffic" / "tiny-train.json").write_text(json.dumps(TINY_TRAIN))
    (bench / "traffic" / "tiny-dp.json").write_text(json.dumps(TINY_DP))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "make_tiny_cfg",
                            "file": "benchmark/configs/tiny.json", "reduced": [], "why": "tests"})
    spec["workloads"] += [
        {"name": "tiny.register", "config": "tiny", "traffic": "tiny-register", "chips": 1,
         "why": "tests"},
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny-train", "chips": 1,
         "why": "tests"},
        {"name": "tiny.dp", "config": "tiny", "traffic": "tiny-dp", "chips": 4, "why": "tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        for real, tiny in (("kitti.register", "tiny.register"), ("kitti.train", "tiny.train"),
                           ("kitti.train_dp4", "tiny.dp")):
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell, real in (("tiny.register", "kitti.register"), ("tiny.train", "kitti.train"),
                       ("tiny.dp", "kitti.train_dp4")):
        src = REPO / "benchmark" / "limits" / f"{real}.json"
        lim = limits if limits is not None else (json.loads(src.read_text()) if src.exists()
                                                  else {})
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    return dest
