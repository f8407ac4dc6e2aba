"""A small cell for the CPU tests: the SGV configuration's file with n and
m cut, run by the same harness."""

from __future__ import annotations

import json

from portbench.lib import entries
from portbench.lib.cell import BENCH, ROOT, Cell, load_traffic


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(traffic, n=1500, m=8):
    cfg = json.loads((BENCH / "configs" / "sgv-1e6-m40.json").read_text())
    cfg["n"] = n
    cfg["specify"]["m"] = m
    b = bench()
    work = {"name": f"tiny.{traffic}", "config": "tiny", "traffic": traffic,
            "chips": 1}
    tr = load_traffic(traffic)
    suffix = ".vg" if entries.load_kind(tr).Entry.grad else ".eval"
    per = [m for m in b["per_layer"] if m["name"].endswith(suffix)
           or "." not in m["name"]]
    return Cell(work, json.dumps(cfg).encode(), tr, b["end_to_end"], per)
