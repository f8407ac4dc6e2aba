"""Kinds of traffic are modules found by the traffic's ``entry``: a new
kind is a new file, which the harness runs, checks and prices without an
edit; and the Gaussian kinds draw, step and price as the harness always
has."""

from __future__ import annotations

import hashlib
import math
import sys

import numpy as np
import pytest
import torch

import portbench.kinds
import portbench.run as R
from portbench.costs import frozen
from portbench.lib import data, entries
from portbench.lib import trace as tr
from portbench.lib.cell import BENCH
from portbench.lib.trace import Step
from portbench.tests.helpers import tiny_cell

TWICE = '''
"""A throwaway kind: the closed-form value evaluated twice a step, and
priced as two passes."""
from portbench.kinds import loglik_value as base


class Entry(base.Entry):
    def __call__(self, lg):
        super().__call__(lg)
        return super().__call__(lg)


inputs, points, check = base.inputs, base.points, base.check


def passes(*args):
    return [p for p in base.passes(*args) for _ in range(2)]
'''


def _files():
    """{path under portbench/: digest} of the benchmark's own files."""
    return {str(f.relative_to(BENCH)): hashlib.sha256(
        f.read_bytes()).hexdigest() for f in sorted(BENCH.rglob("*"))
        if f.is_file() and "__pycache__" not in f.parts
        and ".cache" not in f.parts}


def test_new_kind_needs_no_edit(tmp_path, monkeypatch):
    before = _files()
    kdir = tmp_path / "kinds"
    kdir.mkdir()
    (kdir / "twice_value.py").write_text(TWICE)
    monkeypatch.setattr(portbench.kinds, "__path__",
                        [str(kdir), *portbench.kinds.__path__])
    cell = tiny_cell("loglik")
    cell.traffic = dict(cell.traffic, entry="twice_value")
    seen = []
    bounds = tr.layer_bounds

    def spy(plan, steps, *rest):
        seen.append(list(steps))
        return bounds(plan, steps, *rest)

    monkeypatch.setattr(tr, "layer_bounds", spy)
    try:
        out = R.run_cell(cell, 2 ** 31 + 7, 0.5, 1, "cpu",
                         cache_dir=tmp_path / "cache", log=lambda m: None)
    finally:
        sys.modules.pop("portbench.kinds.twice_value", None)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1
    # the parent kind prices a step at nu = 0.5 as one forward pass
    assert seen == [[Step(grad=False, general_ops=None)]
                    * (2 * out["attempted"])]
    assert _files() == before


def _design_as_drawn(traffic):
    """The Latin hypercube of the log box (sig2, range, nu, nugget) as the
    harness has always drawn it."""
    P = int(traffic["design_points"])
    r = np.random.default_rng(int(traffic["design_seed"]))
    keys = ("sig2", "range", "nu", "nugget")
    u = (np.stack([r.permutation(P) for _ in keys], axis=1)
         + r.uniform(size=(P, 4))) / P
    lo = np.log([traffic["box"][k][0] for k in keys])
    hi = np.log([traffic["box"][k][1] for k in keys])
    return lo + (hi - lo) * u


@pytest.mark.parametrize("traffic", ["mle", "loglik"])
def test_gaussian_kinds_draw_step_and_price_as_before(traffic):
    cell = tiny_cell(traffic)
    t = cell.traffic
    kind = entries.load_kind(t)
    locs = data.locations(cell.config)
    for seed in (3, 2 ** 33 + 5):
        assert torch.equal(kind.inputs(locs, t, seed, "cpu"),
                           data.observations(locs, t["field"], seed, "cpu"))
    d = _design_as_drawn(t)
    P = d.shape[0]
    pts = kind.points(t, 2 * P + 1)
    assert np.array_equal(pts, np.concatenate([d, d, d[:1]]))

    spec = entries.build_spec(locs, cell.config)
    few = pts[:3]
    got = kind.passes(spec, t, few, torch.float64, "cpu", kind.Entry)
    if t["box"]["nu"] == [0.5, 0.5]:
        assert got == [Step(grad=False, general_ops=None)] * len(few)
        return
    _, ls, NN = entries.plan_shapes(spec)
    lt, nt = torch.as_tensor(ls), torch.as_tensor(NN)
    want = [Step(grad=True, general_ops=frozen.gen_ops(
        lt, nt, nt >= 0, math.exp(lg[1]), math.exp(lg[2]), torch.float64,
        row_stride=16)) for lg in few]
    assert got == want
