"""The plain reference against the port on the CPU at a small size: the
same spec array for array, and the same value and gradient to what the
port's own derivatives allow (its d/dnu is a central difference)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.reference import spec as rspec
from portbench.reference.likelihood import bessel_k


@pytest.fixture(scope="module")
def case():
    from gpvecchia_torch.spec import vecchia_specify
    rng = np.random.default_rng(4)
    n, m = 1200, 10
    locs = rng.uniform(size=(n, 2))
    z = np.sin(5 * locs[:, 0]) + np.cos(4 * locs[:, 1]) \
        + 0.3 * rng.normal(size=n)
    spec = vecchia_specify(locs, m=m, cond_yz="SGV")
    cfg = {"specify": {"m": m, "cond_yz": "SGV"}}
    arrays = reference.build(locs, cfg, "cpu")
    return spec, arrays, reference.problem(arrays, locs, z, "cpu"), z


def test_spec_matches_the_port(case):
    spec, arrays, _, _ = case
    assert np.array_equal(arrays["ord"], spec.ord)
    assert np.array_equal(arrays["NN"], spec.NNarray)
    assert np.array_equal(arrays["cond"], spec.cond_latent)


@pytest.mark.parametrize("point", [(1.0, 0.1, 0.8, 0.1),
                                   (0.5, 0.05, 1.2, 0.2),
                                   (2.0, 0.2, 0.6, 0.05)])
def test_value_and_gradient_match_the_port(case, point):
    from gpvecchia_torch.fit.mle import neg_loglik_fn
    spec, _, prob, z = case
    lg = np.log(point)
    f = neg_loglik_fn(spec, z, 4, device="cpu", dtype=torch.float64)
    lgt = torch.tensor(lg, requires_grad=True)
    v = f(lgt)
    (g,) = torch.autograd.grad(v, lgt)
    rv, rg, bad = prob.value_grad(lg)
    assert bad == 0
    assert abs(float(v.detach()) - rv) <= 1e-11 * abs(rv)
    assert np.abs(g.numpy() - rg).max() <= 1e-8 * np.abs(rg).max()


def test_closed_form_value(case):
    from gpvecchia_torch import loglik_fn
    spec, _, prob, z = case
    fn = loglik_fn(spec, device="cpu", dtype=torch.float64)
    ll = fn(z, torch.tensor([1.3, 0.07, 0.5], dtype=torch.float64), 0.12)
    rv, _ = prob.value(np.log([1.3, 0.07, 0.5, 0.12]), closed_half=True)
    assert abs(-float(ll) - rv) <= 1e-11 * abs(rv)


@pytest.mark.parametrize("nu", [0.5, 0.6, 0.83, 1.0, 1.2])
def test_bessel_k_against_scipy(nu):
    sp = pytest.importorskip("scipy.special")
    x = torch.logspace(-6, 1.6, 300, dtype=torch.float64)
    k = bessel_k(torch.tensor(nu, dtype=torch.float64), x).numpy()
    assert np.abs(k / sp.kv(nu, x.numpy()) - 1).max() < 1e-12


def test_maxmin_is_greedy():
    """Each ordered point is, among those not yet taken, one farthest from
    those taken (before the head rotation)."""
    locs = np.random.default_rng(9).uniform(size=(300, 2))
    o = rspec.maxmin_order(locs)
    o = np.concatenate([o[:1], o[-8:], o[1:-8]])      # undo the rotation
    for k in range(1, 60):
        taken = locs[o[:k]]
        rest = o[k:]
        d = np.sqrt(((locs[rest, None] - taken[None]) ** 2).sum(-1)).min(1)
        assert math.isclose(d[0], d.max())


def test_mra_spec_and_value_match_the_port():
    """MRA at its default options: the same sets, value and gradient."""
    from gpvecchia_torch.fit.mle import neg_loglik_fn
    from gpvecchia_torch.spec import vecchia_specify
    rng = np.random.default_rng(6)
    n, m = 3000, 20
    locs = rng.uniform(size=(n, 2))
    z = np.cos(6 * locs[:, 0] * locs[:, 1]) + 0.3 * rng.normal(size=n)
    spec = vecchia_specify(locs, m=m, conditioning="mra")
    arrays = reference.build(locs, {"specify": {"m": m,
                                                "conditioning": "mra"}},
                             "cpu")
    assert np.array_equal(arrays["ord"], spec.ord)
    assert np.array_equal(arrays["NN"], spec.NNarray)
    assert np.array_equal(arrays["cond"], spec.cond_latent)
    prob = reference.problem(arrays, locs, z, "cpu")
    lg = np.log([0.8, 0.12, 0.9, 0.08])
    lgt = torch.tensor(lg, requires_grad=True)
    v = neg_loglik_fn(spec, z, 4, device="cpu", dtype=torch.float64)(lgt)
    (g,) = torch.autograd.grad(v, lgt)
    rv, rg, bad = prob.value_grad(lg)
    assert bad == 0
    assert abs(float(v.detach()) - rv) <= 1e-11 * abs(rv)
    assert np.abs(g.numpy() - rg).max() <= 1e-8 * np.abs(rg).max()
