"""The port's Gaussian Vecchia log-likelihood (the slice as a whole) vs the
JAX package on the CPU in float64, and vs dense-GP and golden values.

Inputs are made with numpy from a seed and handed to both packages.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist
from scipy.stats import multivariate_normal

import gpvecchia_tpu as GJ

import gpvecchia_torch as GT

from reference_impl import matern_np

torch.set_default_dtype(torch.float64)

REL = 1e-11


def _data(n=150, seed=1988, covparms=(1.0, 0.3, 0.5), nug=0.2):
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    Sigma = matern_np(cdist(locs, locs), covparms)
    z = rng.multivariate_normal(np.zeros(n), Sigma + nug * np.eye(n))
    return locs, z, Sigma


def _both(locs, z, covparms, nug, **kw):
    ll_t = GT.vecchia_likelihood(z, GT.vecchia_specify(locs, **kw), covparms,
                                 nug, device="cpu")
    ll_j = GJ.vecchia_likelihood(z, GJ.vecchia_specify(locs, **kw), covparms,
                                 nug)
    return ll_t, ll_j


@pytest.mark.parametrize("cond,nu", [("y", 0.5), ("z", 0.5), ("SGV", 0.5),
                                     ("SGVT", 0.5), ("SGV", 1.5),
                                     ("SGV", 2.5)])
def test_matches_jax(cond, nu):
    locs, z, _ = _data(covparms=(1.0, 0.3, nu))
    ll_t, ll_j = _both(locs, z, (1.0, 0.3, nu), 0.2, m=10, cond_yz=cond)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


def test_vector_nuggets_and_na_match_jax():
    locs, z, _ = _data()
    nug = np.linspace(0.1, 0.4, len(z))
    z = z.copy()
    z[[3, 17]] = np.nan
    ll_t, ll_j = _both(locs, z, (1.0, 0.3, 0.5), nug, m=10)
    assert np.isfinite(ll_t)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


def test_zero_nugget_matches_jax():
    locs, z, _ = _data()
    nug = np.full(len(z), 0.2)
    nug[[0, 5, 40]] = 0.0
    ll_t, ll_j = _both(locs, z, (1.0, 0.3, 0.5), nug, m=10)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


def test_all_zero_nuggets_match_jax():
    """Every observation exact: no latent left, no denominator."""
    locs, z, _ = _data(n=60)
    ll_t, ll_j = _both(locs, z, (1.0, 0.3, 0.5), 0.0, m=6)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


def test_m0_matches_jax():
    locs, z, _ = _data(n=60)
    ll_t, ll_j = _both(locs, z, (1.0, 0.3, 0.5), 0.2, m=0)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


def test_grid_50x50_m20_matches_jax():
    """BASELINE config 1's size: a 50 x 50 grid, m=20.

    A regular grid is full of distance near-ties, which the host C++ breaks
    by its last rounding: the JAX package builds it with -march=native (FMA
    contraction), the port without, so their orderings differ here.  The
    likelihoods are compared on one spec, the port's, handed to both."""
    g = np.linspace(0.0, 1.0, 50)
    locs = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    z = np.random.default_rng(3).normal(size=len(locs))
    spec = GT.vecchia_specify(locs, m=20)
    spec_j = GJ.VecchiaSpec(**{f: getattr(spec, f) for f in (
        "locsord", "NNarray", "cond_latent", "has_latent", "has_obs", "ord",
        "ord_z", "ordering_pred", "cond_yz", "conditioning", "ic0", "n_obs",
        "n_pred")})
    ll_t = GT.vecchia_likelihood(z, spec, (1.0, 0.1, 0.5), 0.1, device="cpu")
    ll_j = GJ.vecchia_likelihood(z, spec_j, (1.0, 0.1, 0.5), 0.1)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


@pytest.mark.parametrize("cond", ["y", "SGV"])
def test_exact_when_m_full(cond):
    locs, z, Sigma = _data(n=60)
    spec = GT.vecchia_specify(locs, m=59, cond_yz=cond)
    ll = GT.vecchia_likelihood(z, spec, (1.0, 0.3, 0.5), 0.2, device="cpu")
    exact = multivariate_normal.logpdf(z, np.zeros(60),
                                       Sigma + 0.2 * np.eye(60))
    assert abs(ll - exact) < 1e-8


@pytest.mark.parametrize("cond,want", [("SGV", -398.7167975671508),
                                       ("y", -397.881292926102),
                                       ("z", -398.55472750828096)])
def test_golden_values(cond, want):
    """The JAX package's fixed-seed golden values (tests/test_likelihood.py)."""
    rng = np.random.default_rng(1988)
    locs = rng.uniform(size=(200, 2))
    z = rng.normal(size=200)
    spec = GT.vecchia_specify(locs, m=12, cond_yz=cond)
    ll = GT.vecchia_likelihood(z, spec, (1.2, 0.25, 0.5), 0.15,
                               device="cpu")
    np.testing.assert_allclose(ll, want, rtol=REL)


@pytest.mark.parametrize("case", ["general_nu", "esqe", "zy"])
def test_unported_paths_raise(case):
    """The specs that raised before the per-entry V engine was ported now
    match the JAX package: a general smoothness on an IC0 spec, esqe on a
    spec with obspred prediction points and the zy family."""
    locs, z, _ = _data(n=40)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "general_nu":
            kw = dict(m=5, ic0=True)
            args = ((1.0, 0.3, 0.8), 0.2)
            cov = {}
        elif case == "esqe":
            kw = dict(m=5, locs_pred=locs[:4] + 0.01,
                      ordering_pred="obspred")
            args = ((0.8, 0.5, 0.4, 0.2), 0.2)
            cov = {"covmodel": "esqe"}
        else:
            kw = dict(m=5, cond_yz="zy")
            args = ((1.0, 0.3, 0.5), 0.2)
            cov = {}
        ll_t = GT.vecchia_likelihood(z, GT.vecchia_specify(locs, **kw),
                                     *args, device="cpu", **cov)
        ll_j = GJ.vecchia_likelihood(z, GJ.vecchia_specify(locs, **kw),
                                     *args, **cov)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


def test_zcache_follows_in_place_updates():
    locs, z, _ = _data(n=80)
    spec = GT.vecchia_specify(locs, m=8)
    fn = GT.loglik_fn(spec, device="cpu")
    zt = torch.as_tensor(z.copy())
    a = float(fn(zt, (1.0, 0.3, 0.5), 0.2))
    zt.mul_(2.0)                       # same tensor, new contents
    b = float(fn(zt, (1.0, 0.3, 0.5), 0.2))
    c = GT.vecchia_likelihood(2.0 * z, spec, (1.0, 0.3, 0.5), 0.2,
                              device="cpu")
    assert a != b
    np.testing.assert_allclose(b, c, rtol=1e-13)


def test_zcache_sees_an_edit_anywhere_in_a_numpy_z():
    """A numpy z is keyed on its whole content: an in-place edit of an
    element that a sampled fingerprint (every len/64-th) would skip gives
    the fresh likelihood, equal to a new ``loglik_fn``'s."""
    locs, z, _ = _data(n=150)
    spec = GT.vecchia_specify(locs, m=8)
    fn = GT.loglik_fn(spec, device="cpu")
    z = z.copy()
    a = float(fn(z, (1.0, 0.3, 0.5), 0.2))
    z[1] += 3.0                        # 150 // 64 = 2: index 1 is unsampled
    b = float(fn(z, (1.0, 0.3, 0.5), 0.2))
    spec2 = GT.vecchia_specify(locs, m=8)
    c = float(GT.loglik_fn(spec2, device="cpu")(z.copy(), (1.0, 0.3, 0.5),
                                                0.2))
    assert a != b
    np.testing.assert_allclose(b, c, rtol=0, atol=0)


def test_float32_on_cpu_close_to_float64():
    locs, z, _ = _data(n=300)
    spec = GT.vecchia_specify(locs, m=10)
    ll64 = GT.vecchia_likelihood(z, spec, (1.0, 0.3, 0.5), 0.2, device="cpu")
    ll32 = GT.vecchia_likelihood(z, spec, (1.0, 0.3, 0.5), 0.2, device="cpu",
                                 dtype=torch.float32)
    np.testing.assert_allclose(ll32, ll64, rtol=1e-5)
