"""The frozen cost functions give the same (bytes, operations) as the
repository's ``chip_smoke.py`` originals: H4 and H9 at the 14 level shapes
of n = 1e6, m = 40 (``H4_LEVELS_1E6``), the assembly kernels and the
posterior on a small plan, and the general Matern's pair operations, in
float32 and float64."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from portbench.costs import frozen

DTYPES = [torch.float32, torch.float64]


def _sz(dt):
    return torch.empty((), dtype=dt).element_size()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", cs.H4_LEVELS_1E6)
def test_h4_h9_levels(dt, shape):
    N, F1, P = shape
    assert frozen.cost_h4(_sz(dt), N, F1, P) == cs.cost_h4(dt, N, F1, P)
    assert frozen.cost_h9(_sz(dt), N, F1, P) == cs.cost_h9(dt, N, F1, P)


@pytest.fixture(scope="module")
def small_plan():
    from gpvecchia_torch.plan import get_mf_plan, get_plan
    from gpvecchia_torch.spec import vecchia_specify
    locs = np.random.default_rng(0).uniform(size=(1200, 2))
    spec = vecchia_specify(locs, m=8, cond_yz="SGV")
    plan = get_plan(spec)
    return get_mf_plan(plan)[0], plan


@pytest.mark.parametrize("dt", DTYPES)
def test_assembly_and_posterior(dt, small_plan):
    mf, _ = small_plan
    sz = _sz(dt)
    leaf = mf.levels[mf.depth]
    N = leaf.piv_ids.shape[0]
    F1 = leaf.npiv + leaf.nbord + 1
    n_in, ops = frozen.leaf_inputs(leaf, F1)
    assert frozen.cost_h2(sz, N, F1, leaf.elem_pos, n_in, ops) == \
        cs.cost_h2(dt, N, F1, leaf.elem_pos, n_in, ops)
    for d in range(mf.depth):
        lv, lc = mf.levels[d], mf.levels[d + 1]
        F1 = lv.npiv + lv.nbord + 1
        Bc1 = lc.nbord + 1
        ext = frozen.ext_aug(lv, F1, Bc1)
        assert np.array_equal(ext, cs._ext_aug(lv, F1, Bc1))
        Nd = lv.piv_ids.shape[0]
        assert frozen.cost_h3(sz, Nd, F1, ext) == cs.cost_h3(dt, Nd, F1, ext)
        assert frozen.cost_h6(sz, Nd, F1, Bc1, ext) == \
            cs.cost_h6(dt, Nd, F1, Bc1, ext)
    assert frozen.cost_posterior(mf, sz) == cs.cost_posterior(mf, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nu", [0.6, 0.8, 1.2])
def test_general_pair_ops(dt, nu, small_plan):
    _, plan = small_plan
    locs = torch.as_tensor(plan.locs, dtype=torch.float64)
    NN = torch.as_tensor(plan.NN)
    valid = NN >= 0
    covparms = (1.0, 0.07, nu)
    want = cs._gen_ops((locs, NN, valid), covparms, dt)
    got = frozen.gen_ops(locs, NN, valid, covparms[1], nu, dt)
    assert got == pytest.approx(want, rel=1e-12)
