"""The port's Vecchia–Laplace inference vs the JAX package, on the CPU in
float64: the six likelihood models' posterior mean, iteration count,
convergence flag, pseudo-nuggets and VL log-likelihood, prediction through
the data link with missing data, and the raises of the paths that are not
ported.  Inputs are made with numpy from a seed.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

from gpvecchia_tpu.inference import laplace as JL

import gpvecchia_torch as GT
from gpvecchia_torch.inference import laplace as TL

from reference_impl import matern_np
from test_torch_prediction import jax_spec

COVPARMS = (1.0, 0.3, 0.5)
MEAN_ATOL = 1e-8
REL = 1e-8


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(1989)
    n = 120
    locs = rng.uniform(size=(n, 2))
    y = rng.multivariate_normal(np.zeros(n),
                                matern_np(cdist(locs, locs), COVPARMS))
    spec = GT.vecchia_specify(locs, m=10, cond_yz="y")
    data = {
        "gaussian": y + rng.normal(scale=np.sqrt(0.1), size=n),
        "logistic": rng.binomial(1, 1 / (1 + np.exp(-y))).astype(float),
        "poisson": rng.poisson(np.exp(y)).astype(float),
        "gamma": rng.gamma(2.0, np.exp(y) / 2.0),
        "gamma_alt": rng.gamma(2.0, np.exp(-y)),
        "beta": rng.beta(2.0 / (1 + np.exp(-y)), 1.0),
    }
    return locs, spec, jax_spec(spec), data, rng


@pytest.mark.parametrize("model", ["gaussian", "logistic", "poisson",
                                   "gamma", "gamma_alt", "beta"])
def test_vl_matches_jax(field, model):
    """Mean, iterations, convergence, pseudo-nuggets D and the VL
    log-likelihood; on the beta model D carries torch's and XLA's
    digamma/trigamma, which differ in the last digits."""
    _, spec, sj, data, _ = field
    z = data[model]
    got = GT.calculate_posterior_VL(z, spec, model, COVPARMS, device="cpu")
    want = JL.calculate_posterior_VL(z, sj, model, COVPARMS)
    assert (got["iter"], got["cnvgd"]) == (want["iter"], want["cnvgd"])
    assert got["cnvgd"]
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0,
                               atol=MEAN_ATOL)
    np.testing.assert_allclose(got["D"], want["D"], rtol=REL)
    np.testing.assert_allclose(got["t"], want["t"], rtol=0,
                               atol=MEAN_ATOL * np.abs(want["t"]).max())
    ll = GT.vecchia_laplace_likelihood(z, spec, model, COVPARMS,
                                       device="cpu")
    np.testing.assert_allclose(
        ll, JL.vecchia_laplace_likelihood(z, sj, model, COVPARMS), rtol=1e-9)


def test_max_iter_stops_unconverged(field):
    """A solve cut by max_iter reports it, as the JAX package does."""
    _, spec, sj, data, _ = field
    z = data["poisson"]
    got = GT.calculate_posterior_VL(z, spec, "poisson", COVPARMS, max_iter=2,
                                    device="cpu")
    want = JL.calculate_posterior_VL(z, sj, "poisson", COVPARMS, max_iter=2)
    assert (got["iter"], got["cnvgd"]) == (2, False)
    assert (want["iter"], want["cnvgd"]) == (2, False)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0,
                               atol=MEAN_ATOL)
    with pytest.warns(UserWarning, match="Convergence Failed"):
        assert GT.vecchia_laplace_likelihood(
            z, spec, "poisson", COVPARMS, max_iter=2,
            device="cpu") == -np.inf


def test_vl_prediction_with_missing_data_matches_jax(field):
    """Missing data, then prediction through the exp link with its 95 %
    quantiles on a spec with prediction points (general ordering)."""
    locs, _, _, data, rng = field
    z = data["poisson"].copy()
    z[[5, 17, 60]] = np.nan
    spec = GT.vecchia_specify(locs, m=10, cond_yz="y")
    post = GT.calculate_posterior_VL(z, spec, "poisson", COVPARMS,
                                     device="cpu")
    jpost = JL.calculate_posterior_VL(z, jax_spec(spec), "poisson", COVPARMS)
    assert post["cnvgd"] and post["iter"] == jpost["iter"]
    np.testing.assert_allclose(post["mean"], jpost["mean"], rtol=0,
                               atol=MEAN_ATOL)
    locs_pred = rng.uniform(size=(25, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec_p = GT.vecchia_specify(locs, m=10, locs_pred=locs_pred,
                                    cond_yz="y", ordering_pred="general")
    got = GT.vecchia_laplace_prediction(post, spec_p, COVPARMS, device="cpu")
    want = JL.vecchia_laplace_prediction(jpost, jax_spec(spec_p), COVPARMS)
    for k in ("mu_pred", "mu_obs", "var_pred", "var_obs", "data_pred",
              "data_obs", "data_pred_upper_quantile",
              "data_pred_lower_quantile", "data_obs_upper_quantile",
              "data_obs_lower_quantile"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
    assert np.all(got["data_pred"] > 0)
    assert np.all(got["data_pred_upper_quantile"] >= got["data_pred"])
    assert np.all(got["data_pred_lower_quantile"] <= got["data_pred"])


@pytest.mark.parametrize("case", ["zy", "obspred", "negbinomial",
                                  "invalid_data"])
def test_unported_and_invalid_raise(field, case):
    locs, spec, _, data, _ = field
    z = data["logistic"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "zy":
            spec = GT.vecchia_specify(locs, m=5, cond_yz="zy")
        elif case == "obspred":
            spec = GT.vecchia_specify(locs, m=5, locs_pred=locs[:4] + 0.01,
                                      cond_yz="SGV", ordering_pred="obspred")
    if case == "negbinomial":
        with pytest.raises(NotImplementedError, match="stub"):
            GT.calculate_posterior_VL(z, spec, "negbinomial", COVPARMS,
                                      device="cpu")
    elif case == "invalid_data":
        for model in ("logistic", "poisson", "gamma", "beta"):
            with pytest.raises(ValueError, match="support"):
                GT.calculate_posterior_VL(np.full(z.size, -1.0), spec, model,
                                          COVPARMS, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="queue 1, item 6"):
            GT.calculate_posterior_VL(z, spec, "logistic", COVPARMS,
                                      device="cpu")


def test_interweaved_likelihood_of_a_zy_spec(field):
    """A zy-family spec's VL likelihood is taken on an SGV spec of the
    observed locations (the reference's interweaved re-specification):
    the same as passing that spec."""
    locs, spec, _, data, _ = field
    z = data["logistic"]
    post = GT.calculate_posterior_VL(z, spec, "logistic", COVPARMS,
                                     device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        zy = GT.vecchia_specify(locs, m=10, cond_yz="zy")
    got = TL.vecchia_laplace_likelihood_from_posterior(z, post, zy, COVPARMS,
                                                       device="cpu")
    want = TL.vecchia_laplace_likelihood_from_posterior(
        z, post, spec, COVPARMS, spec_iw=GT.vecchia_specify(locs, 10),
        device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_vl_cache_tells_matrices_apart(field):
    """Two full matrices that print alike give different posteriors on one
    spec (the JAX package keys its VL cache on str(covmodel))."""
    locs, _, _, data, _ = field
    spec = GT.vecchia_specify(locs[:60], m=8)
    A = matern_np(cdist(spec.locsord, spec.locsord), (1.0, 0.3, 0.8))
    B = A.copy()
    B[10:50, 10:50] += 0.5 * np.eye(40)
    assert str(A) == str(B)
    z = data["logistic"][:60]

    def mean(cov, s):
        return GT.calculate_posterior_VL(z, s, "logistic", (), covmodel=cov,
                                         device="cpu")["mean"]

    mu_a, mu_b = mean(A, spec), mean(B, spec)
    assert np.max(np.abs(mu_a - mu_b)) > 1e-3
    np.testing.assert_allclose(mu_b, mean(B, GT.vecchia_specify(locs[:60],
                                                                m=8)),
                               rtol=1e-13)


def test_vl_defaults_to_the_card(field):
    """Without a visible CUDA device the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    _, spec, _, data, _ = field
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GT.calculate_posterior_VL(data["logistic"], spec, "logistic",
                                  COVPARMS)
