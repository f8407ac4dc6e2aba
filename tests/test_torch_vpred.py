"""The port's posterior on the per-entry V engine vs the JAX package, on the
CPU in float64: prediction means, selected-inverse and exact prediction
variances on the zy family's default prediction spec, obspred SGV and MRA
specs and IC0; lincombs and ``V2covmat`` on a V factor; zero nuggets
(likelihood and prediction); Vecchia-Laplace on a zy spec; and the dense
posterior of ``reference_impl``.  The data and specs are
``test_torch_vengine``'s.
"""

import warnings

import numpy as np
import pytest
import torch

import gpvecchia_tpu as GJ
from gpvecchia_tpu.inference import laplace as JL
from gpvecchia_tpu.inference.likelihood import \
    zero_nugget_variant as jax_zero_nugget_variant
from gpvecchia_tpu.inference.prediction import V2covmat as jax_V2covmat
from gpvecchia_tpu.inference.prediction import \
    vecchia_prediction as jax_prediction

import gpvecchia_torch as GT
from gpvecchia_torch.inference.likelihood import zero_nugget_variant
from gpvecchia_torch.inference.prediction import V2covmat, vecchia_lincomb

from reference_impl import dense_posterior
from test_torch_vengine import (COVPARMS, NUG, REL, _rel, make_data,
                                make_spec)

torch.set_default_dtype(torch.float64)

OUTPUTS = ("mu_obs", "mu_pred", "var_obs", "var_pred")


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture(scope="module")
def cases(data):
    """case -> (port spec, JAX spec, the JAX package's prediction with its
    V), each made once for the module."""
    memo = {}

    def get(case):
        if case not in memo:
            spec, sj = make_spec(data, case)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                memo[case] = (spec, sj, jax_prediction(data[2], sj, COVPARMS,
                                                       NUG))
        return memo[case]

    return get


def _port(data, spec, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GT.vecchia_prediction(data[2], spec, COVPARMS, NUG,
                                     device="cpu", **kw)


@pytest.mark.parametrize("case", ["zy_pred", "obspred", "mra_obspred",
                                  "ic0"])
def test_prediction_matches_jax(data, cases, case):
    """Means, selected-inverse variances and, on obspred specs, the exact
    prediction variances (and, with var_exact=False, the selected
    inverse's) against the JAX package."""
    spec, sj, pj = cases(case)
    pt = _port(data, spec)
    for k in OUTPUTS:
        if pj[k] is not None and np.size(pj[k]):
            assert _rel(pt[k], pj[k]) <= REL, k
    if spec.n_pred:
        pt = _port(data, spec, var_exact=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pj = jax_prediction(data[2], sj, COVPARMS, NUG, var_exact=False)
        assert _rel(pt["var_pred"], pj["var_pred"]) <= REL


@pytest.mark.parametrize("case", ["zy_pred", "obspred"])
def test_prediction_against_dense_oracle(data, cases, case):
    """The means and the exact prediction variances are the dense
    posterior's of the same spec (``reference_impl.dense_posterior``)."""
    spec, sj, _ = cases(case)
    pt = _port(data, spec)
    ref = dense_posterior(data[2], sj, COVPARMS, NUG)
    for k in ("mu_obs", "mu_pred", "var_pred"):
        assert _rel(pt[k], ref[k]) <= 1e-9, k


@pytest.mark.parametrize("case", ["zy_pred", "obspred"])
def test_lincomb_and_V2covmat_on_a_V_factor(data, cases, case):
    """V (a tensor in the physical layout) is the JAX package's; V2covmat
    is the JAX package's, and the lincombs are H Sigma H^T of it."""
    spec, sj, pj = cases(case)
    V = _port(data, spec, return_values="meanmat")["V"]
    assert torch.is_tensor(V) and _rel(V.numpy(), pj["V"]) <= REL
    got, want = V2covmat(spec, V), jax_V2covmat(sj, pj["V"])
    for k in ("Sigma_obs", "Sigma_pred"):
        assert _rel(got[k], want[k]) <= REL
    n = spec.n_obs
    Sigma = np.zeros((spec.ord.size,) * 2)
    Sigma[:n, :n], Sigma[n:, n:] = want["Sigma_obs"], want["Sigma_pred"]
    rng = np.random.default_rng(4)
    for part in (slice(0, n), slice(n, None)):
        # one block at a time: V2covmat does not return the cross block
        H = np.zeros((3, spec.ord.size))
        H[:, part] = rng.normal(size=H[:, part].shape)
        cov = vecchia_lincomb(H, spec, V, cov_mat=True)
        assert _rel(cov, H @ Sigma @ H.T) <= 1e-10
        np.testing.assert_allclose(vecchia_lincomb(H, spec, V),
                                   np.diag(cov), rtol=1e-13)
    with pytest.raises(ValueError, match="V values"):
        vecchia_lincomb(H, spec, V[:-1])


@pytest.mark.parametrize("case", ["zy", "ic0", "obspred"])
def test_zero_nuggets_match_jax(data, cases, case):
    """Exact observations: the zy family's known-twin surgery, IC0 and the
    obspred mode; likelihood and prediction (mean = datum, variance 0)."""
    spec, sj = make_spec(data, case)
    z = data[2]
    nug = np.full(z.size, NUG)
    nug[[1, 7, 30]] = 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = GT.vecchia_likelihood(z, spec, COVPARMS, nug, device="cpu")
        want = GJ.vecchia_likelihood(z, sj, COVPARMS, nug)
        pt = GT.vecchia_prediction(z, spec, COVPARMS, nug, var_exact=False,
                                   device="cpu")
        pj = jax_prediction(z, sj, COVPARMS, nug, var_exact=False)
    assert abs(got - want) <= REL * abs(want)
    np.testing.assert_array_equal(zero_nugget_variant(spec, nug).NNarray,
                                  jax_zero_nugget_variant(sj, nug).NNarray)
    for k in OUTPUTS:
        if pj[k] is not None and np.size(pj[k]):
            assert _rel(pt[k], pj[k]) <= REL, k
    np.testing.assert_allclose(pt["mu_obs"][nug == 0], z[nug == 0],
                               atol=1e-10)
    np.testing.assert_allclose(pt["var_obs"][nug == 0], 0.0, atol=1e-10)


def test_vl_on_zy_spec_matches_jax(data, cases):
    """calculate_posterior_VL (logistic) on a zy spec: mean, iterations,
    convergence and pseudo-nuggets."""
    yb = (data[2] > 0).astype(float)
    spec, sj = make_spec(data, "zy")
    got = GT.calculate_posterior_VL(yb, spec, "logistic", COVPARMS,
                                    device="cpu")
    want = JL.calculate_posterior_VL(yb, sj, "logistic", COVPARMS)
    assert (got["iter"], got["cnvgd"]) == (want["iter"], want["cnvgd"])
    assert got["cnvgd"]
    assert _rel(got["mean"], want["mean"]) <= 1e-9
    assert _rel(got["D"], want["D"]) <= 1e-9
