"""A whole run of the harness on the CPU at a small size (the look for a
card skipped): the result line's shape, ``correct`` true for the program
as configured, and false for the control (the program in float32, the
configuration's float64 one precision down) and for each fault a cell can
have: an answer altered where it is produced, and half of the data left
out.  Plus the check that no JAX package is loaded."""

from __future__ import annotations

import json
import math
import sys
import types

import pytest
import torch

import portbench.run as R
from portbench.lib import entries
from portbench.tests.helpers import tiny_cell

TRAFFIC = ["mle", "loglik"]


def _run(cell, tmp_path, **kw):
    return R.run_cell(cell, 2 ** 31 + 3, 0.5, 0, "cpu",
                      cache_dir=tmp_path, log=lambda m: None, **kw)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_result_line(traffic, tmp_path):
    cell = tiny_cell(traffic)
    out = _run(cell, tmp_path)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) == names & {
        "setup_s", "peak_device_gib", cell.traffic["rate_metric"]}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_traced_line(traffic, tmp_path):
    cell = tiny_cell(traffic)
    out = R.run_cell(cell, 5, 0.5, 1, "cpu", cache_dir=tmp_path,
                     log=lambda m: None)
    assert out["correct"] is True
    assert "plan_s" in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device operations on the CPU: no share of a roofline is read
    assert not any(k.endswith("roofline.vg") or k.endswith("roofline.eval")
                   for k in out["metrics"])


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_control_is_not_correct(traffic, tmp_path):
    out = _run(tiny_cell(traffic), tmp_path, dtype="float32")
    assert out["correct"] is False
    assert out["checks"]["value_rel"]["value"] > \
        out["checks"]["value_rel"]["limit"]


class _Altered:
    """An entry whose answers are altered where they are produced."""

    def __init__(self, inner, scale):
        self.inner, self.grad, self.scale = inner, inner.grad, scale

    def __call__(self, lg):
        v, g = self.inner(lg)
        return v * self.scale, (None if g is None
                                else [x * self.scale for x in g])


def _patch_entry(monkeypatch, make):
    """The kind loader's product with its ``Entry`` built by
    ``make(Entry, spec, inputs, *rest)``."""
    load = entries.load_kind

    def load_patched(traffic):
        kind = load(traffic)
        out = types.SimpleNamespace(
            **{n: getattr(kind, n) for n in entries.KIND_NAMES})
        out.Entry = lambda *a: make(kind.Entry, *a)
        return out

    monkeypatch.setattr(entries, "load_kind", load_patched)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_altered_answer_is_not_correct(traffic, tmp_path, monkeypatch):
    cell = tiny_cell(traffic)
    _patch_entry(monkeypatch,
                 lambda Entry, *a: _Altered(Entry(*a), 1.0 + 1e-6))
    assert _run(cell, tmp_path)["correct"] is False


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_half_the_data_left_out_is_not_correct(traffic, tmp_path,
                                               monkeypatch):
    def half(Entry, spec, z, *rest):
        z = z.clone()
        z[::2] = math.nan          # the likelihood's missing-data rule
        return Entry(spec, z, *rest)

    cell = tiny_cell(traffic)
    _patch_entry(monkeypatch, half)
    assert _run(cell, tmp_path)["correct"] is False


def test_forbidden_modules(monkeypatch):
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.setitem(sys.modules, "gpvecchia_torch.spec", sys)
    assert R.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "gpvecchia_tpu", sys)
    assert R.forbidden_modules() == ["gpvecchia_tpu", "jax"]


@pytest.mark.card
@pytest.mark.parametrize("traffic", TRAFFIC)
def test_small_cell_on_the_card(traffic, tmp_path):
    """The same small run with the port's CUDA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = R.run_cell(tiny_cell(traffic, n=20000, m=20), 9, 2.0, 1, "cuda",
                     cache_dir=tmp_path, log=lambda m: None)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
    assert all(0 < v["value"] <= 105 for k, v in out["metrics"].items()
               if "roofline" in k or "mfu" in k)
