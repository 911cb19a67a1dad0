"""One run of one benchmark cell of ``rdmnet_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads the cell's files by name (``BENCHMARK.json``,
``benchmark/configs``, ``benchmark/traffic``, ``benchmark/limits``,
``benchmark/metrics``), makes the weights and the traffic from the seed, warms
up the cell's own shapes, measures for ``--seconds``, judges a seeded sample
of the window's outputs against the plain reference (``benchmark/reference``)
and prints one JSON line last on standard output. With ``--trace 1`` the
window is followed by a traced sub-window and the line carries the per-layer
metrics. Exits 2 without the cards the cell needs, 3 when JAX or the JAX
package was loaded (in this process or in a rank it started); neither
prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))
# caches at fixed paths inside the checkout; two host threads, one process a card
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH / ".cache" / "torch_extensions"))
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

from benchmark.harness import cells as cells_mod  # noqa: E402
from benchmark.harness import device as device_mod  # noqa: E402
from benchmark.harness import guard, judge  # noqa: E402
from benchmark.harness.record import Record  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer_metrics(cell, rec) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cells_mod.metric_reader(m["name"], cell.bench_dir)(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell, rec, correct: bool, compared: dict) -> dict:
    line = {"correct": bool(correct), "attempted": rec.attempted, "failed": rec.failed}
    if rec.trace:
        line["metrics"] = per_layer_metrics(cell, rec)
    else:
        line["metrics"] = {m["name"]: {"value": float(rec.e2e[m["name"]]), "unit": m["unit"]}
                           for m in cell.end_to_end if m["name"] in rec.e2e}
    line["device"] = device_mod.device_field(rec.device_count, rec.memory_peak_bytes)
    if rec.trace and rec.timelines:
        busy = [tl.busy_s() for tl in rec.timelines]
        line["device"]["busy_s"] = sum(busy) / len(busy)
        line["device"]["window_s"] = sum(tl.window_s for tl in rec.timelines) / len(rec.timelines)
        worst = max(rec.timelines, key=lambda tl: tl.window_s - tl.busy_s())
        line["breakdown"] = {"device_ops": worst.top_ops(10), "idle_gaps": worst.idle_gaps(10)}
    line["checks"] = compared
    return line


def main(argv=None, *, require_card: bool = True, device=None, t_start: float = None,
         root: Path = None) -> dict:
    """Run one cell. ``require_card=False`` and ``device`` let the tests drive
    a run on the CPU; the command line always requires the cards."""
    args = parse(argv)
    root = Path.cwd() if root is None else Path(root)
    cell = cells_mod.load_cell(root, args.workload)
    if require_card:
        device_mod.require_cards(cell.chips)
        print(f"cards: {device_mod.describe_cards()}", file=sys.stderr)
    import torch

    torch.set_num_threads(2)
    dev = torch.device("cuda" if device is None else device)
    rec = Record(cell=cell.name, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                 device_count=cell.chips)
    drv = cells_mod.driver(cell)
    state = drv.run(cell, rec, dev, T_START if t_start is None else t_start)
    drv.check(cell, rec, dev, state)
    del state
    correct, compared = judge.decide(rec.checks, cell.limits)
    line = result_line(cell, rec, correct, compared)
    found = guard.loaded_forbidden() + rec.forbidden
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        sys.exit(3)
    judge.print_checks(compared)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
