"""The checks' readings on the card, for setting ``correct``'s limits (not
run by the benchmark's own runs).

    python3 portbench/control.py --workload <cell> --seeds 5 6 7 \\
        [--dtype float32] [--seconds 4] [--corners]

Runs the cell as ``run.py`` does for each seed, with the program in
``--dtype`` (float32: the configuration's float64 one precision down, the
control that has to come out not correct), and prints each seed's compared
numbers.  ``--corners`` first prints the kind's corners on the seed 1's
inputs, where its module gives them (``kinds/<entry>.py``): for the
Gaussian kinds the program at the corners and the centre of the traffic's
box in float64 and float32, with the rows each drops (a row whose
conditioning covariance is not positive definite).
"""

from __future__ import annotations

import argparse
import json
import sys

import run as R  # noqa: F401  (sets the cache directories and sys.path)

from portbench.lib import cache, data, entries  # noqa: E402
from portbench.lib.cell import Cell  # noqa: E402


def corners(cell):
    kind = entries.load_kind(cell.traffic)
    if not hasattr(kind, "corners"):
        print(f"control: the kind '{cell.traffic['entry']}' gives no "
              "corners", file=sys.stderr, flush=True)
        return
    locs = data.locations(cell.config)
    spec, _ = cache.program_spec(
        cell, lambda: entries.build_spec(locs, cell.config))
    inputs = kind.inputs(locs, cell.traffic, 1, "cuda")
    for row in kind.corners(spec, inputs, cell.traffic, "cuda"):
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[])
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--corners", action="store_true")
    args = ap.parse_args()
    cell = Cell.find(args.workload)
    if args.corners:
        corners(cell)
    for seed in args.seeds:
        out = R.run_cell(cell, seed, args.seconds, 0, "cuda",
                         dtype=args.dtype,
                         log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"seed": seed, "dtype": args.dtype or
                          cell.config["dtype"], "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)


if __name__ == "__main__":
    main()
