"""A cell's files, found by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = Path(__file__).resolve().parents[1]     # portbench/


class Cell:
    """One workload with its configuration and traffic: ``config`` and
    ``traffic`` are the parsed files, ``config_bytes`` the configuration
    file as it is on disk; ``end_to_end`` and ``per_layer`` the metrics of
    BENCHMARK.json that this cell reports."""

    def __init__(self, workload, config_bytes, traffic, end_to_end=(),
                 per_layer=()):
        self.name = workload["name"]
        self.workload = workload
        self.config_bytes = config_bytes
        self.config = json.loads(config_bytes)
        self.traffic = traffic
        self.chips = int(workload["chips"])
        self.end_to_end = list(end_to_end)
        self.per_layer = list(per_layer)

    @classmethod
    def find(cls, name, bench=None):
        """The cell ``name`` of BENCHMARK.json."""
        bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"unknown workload '{name}'; BENCHMARK.json has "
                           f"{sorted(work)}")
        w = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        return cls(w, (ROOT / conf["file"]).read_bytes(),
                   load_traffic(w["traffic"]),
                   [m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
                   [m for m in bench["per_layer"]
                    if name in m.get("workloads", [name])])


def load_traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def layer_patterns():
    """{layer folder: [kernel-name regexes]}, the union of each layer's
    files."""
    out = {}
    for f in sorted((BENCH / "layers").glob("*/*.json")):
        out.setdefault(f.parent.name, []).extend(
            json.loads(f.read_text())["patterns"])
    return out


def metric_spec(name):
    return json.loads((BENCH / "metrics" / f"{name}.json").read_text())
