"""A run's inputs: the same seed gives the same observations and another
seed others; the parameter points and the locations are fixed by the
traffic's and the configuration's files."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.lib import data
from portbench.lib.cell import BENCH, load_traffic

CFG = json.loads((BENCH / "configs" / "sgv-1e6-m40.json").read_text())
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 33 + 5]


def _small():
    cfg = dict(CFG, n=500)
    return data.locations(cfg)


@pytest.mark.parametrize("traffic", ["mle", "loglik"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(traffic, seed):
    tr = load_traffic(traffic)
    locs = _small()
    z1 = data.observations(locs, tr["field"], seed, "cpu")
    z2 = data.observations(locs, tr["field"], seed, "cpu")
    assert torch.equal(z1, z2)
    p1 = data.points(tr, 50)
    assert np.array_equal(p1, data.points(tr, 50))
    box = tr["box"]
    for j, k in enumerate(data.BOX_KEYS):
        lo, hi = np.log(box[k])
        assert np.all((p1[:, j] >= lo - 1e-12) & (p1[:, j] <= hi + 1e-12))


@pytest.mark.parametrize("traffic", ["mle", "loglik"])
def test_other_seed_other_inputs(traffic):
    tr = load_traffic(traffic)
    locs = _small()
    a, b = SEEDS[2], SEEDS[3]
    assert not torch.equal(data.observations(locs, tr["field"], a, "cpu"),
                           data.observations(locs, tr["field"], b, "cpu"))



@pytest.mark.parametrize("traffic", ["mle", "loglik"])
def test_every_window_asks_for_the_same_work(traffic):
    """The parameter points are the design's, pass after pass, the same
    for every seed and every window length."""
    tr = load_traffic(traffic)
    P = tr["design_points"]
    d = data.design(tr)
    assert d.shape == (P, 4)
    p = data.points(tr, 3 * P + 1)
    for k in range(3):
        assert np.array_equal(p[k * P:(k + 1) * P], d)
    assert np.array_equal(p[3 * P], d[0])


def test_locations_fixed_by_the_file():
    a = data.locations(dict(CFG, n=300))
    assert np.array_equal(a, data.locations(dict(CFG, n=300)))
    assert a.shape == (300, 2) and a.min() >= 0.0 and a.max() <= 1.0
