"""The control of a cell's comparison: the plain reference computed with
TF32 products (the precision below the configuration's float32) put in the
program's place, judged against the float32 reference exactly as a run
judges the program. Its numbers have to fail the cell's limits.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed ({"seed", "checks", "fails"}). Needs a card
(TF32 exists only there)."""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from benchmark.harness import cells as cells_mod  # noqa: E402
from benchmark.harness import device as device_mod  # noqa: E402
from benchmark.harness import judge  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cells_mod.load_cell(Path.cwd(), args.workload)
    device_mod.require_cards(1)
    import torch

    dev = torch.device("cuda")
    drv = cells_mod.driver(cell)
    for seed in args.seeds:
        checks = drv.control(cell, seed, dev)
        ok, compared = judge.decide(checks, cell.limits)
        print(json.dumps({"seed": seed, "checks": checks, "fails": not ok}), flush=True)


if __name__ == "__main__":
    main()
