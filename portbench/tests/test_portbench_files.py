"""The harness finds every configuration, traffic mix, layer, cost and
metric file by the names in BENCHMARK.json, and the file keeps to the
benchmark's contract."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench.lib import cell as cellmod
from portbench.lib import entries
from portbench.lib.cell import BENCH, ROOT, Cell
from portbench.tests.helpers import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = bench()


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = Cell.find(w["name"])
    assert cell.config["name"] == w["config"]
    kind = importlib.import_module(
        f"portbench.kinds.{cell.traffic['entry']}")
    assert all(hasattr(kind, n) for n in entries.KIND_NAMES)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.traffic["rate_metric"] in names
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(m):
    spec = cellmod.metric_spec(m["name"])
    mod = importlib.import_module(f"portbench.readers.{spec['reader']}")
    assert callable(mod.read)
    e2e = {e["name"]: e for e in B["end_to_end"]}
    moved = e2e[m["moves"]]
    for w in m.get("workloads", []):
        assert w in moved.get("workloads", [w])


@pytest.mark.parametrize("layer", sorted(cellmod.layer_patterns()))
def test_layer_has_costs_and_patterns(layer):
    pats = cellmod.layer_patterns()[layer]
    assert pats and all(re.compile(p) for p in pats)
    mod = importlib.import_module(f"portbench.costs.{layer}")
    assert callable(mod.step_cost)


def test_contract_shape():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in B["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in B["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_found_by_name_without_edits(tmp_path, monkeypatch):
    """A new layer and a new metric are files of their own: the harness
    takes them up without an edit."""
    layer = tmp_path / "layers" / "extra"
    layer.mkdir(parents=True)
    (layer / "k.json").write_text(json.dumps({"patterns": ["^zzz"]}))
    for sub in ("factor", "assembly", "u_entries"):
        (tmp_path / "layers" / sub).mkdir()
        for f in (BENCH / "layers" / sub).glob("*.json"):
            (tmp_path / "layers" / sub / f.name).write_text(f.read_text())
    (tmp_path / "layers" / "factor" / "more.json").write_text(
        json.dumps({"patterns": ["^yyy"]}))
    monkeypatch.setattr(cellmod, "BENCH", tmp_path)
    pats = cellmod.layer_patterns()
    assert pats["extra"] == ["^zzz"] and "^yyy" in pats["factor"]
