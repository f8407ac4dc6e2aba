"""MRA / firstm conditioning and the selected covariance layout: the port
vs the JAX package on the CPU in float64.

The host code (MRA parameters, the knot tree native and in Python, specs,
pair slots, ``get_mat_cov``) must equal the JAX package's exactly; the
log-likelihood, its gradient, the prediction mean and Vecchia-Laplace on
MRA specs must agree with it (and the value with ``reference_impl``'s
dense U) to the tolerances below.  Inputs are made with numpy from a seed.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.spatial.distance import cdist

import jax
import jax.numpy as jnp

import gpvecchia_tpu as GJ
from gpvecchia_tpu.geometry import mra as JMRA
from gpvecchia_tpu.hv import get_mat_cov as jax_get_mat_cov
from gpvecchia_tpu.inference import laplace as JL
from gpvecchia_tpu.inference.prediction import \
    vecchia_prediction as jax_prediction
from gpvecchia_tpu.plan import get_sel_pair_slots as jax_sel_pair_slots
from gpvecchia_tpu.utils.serialize import save_spec

import gpvecchia_torch as GT
from gpvecchia_torch.convert import from_jax_spec, load_spec
from gpvecchia_torch.csrc import host
from gpvecchia_torch.geometry import mra as TMRA
from gpvecchia_torch.hv import get_mat_cov
from gpvecchia_torch.plan import (_sel_slot_table, get_sel_pair_slots,
                                  sel_pair_slots_packed)

from reference_impl import dense_loglik, matern_np

torch.set_default_dtype(torch.float64)

COVPARMS = (1.0, 1.0, 0.5)
NUG = 1e-4
REL = 1e-9           # log-likelihood, relative
GRAD_REL = 1e-8      # gradient, of |g|max
MEAN_ATOL = 1e-9     # prediction mean and covmodel-type agreement
SPEC_ARRAYS = ("locsord", "NNarray", "cond_latent", "has_latent", "has_obs",
               "ord", "ord_z")

# the native-vs-Python tree cases of tests/test_mra.py
TREE_CASES = [(800, 10, None), (1000, 10, {"r": [0, 32]}),
              (900, 12, {"r": [12, 1]}), (1100, 9, {"M": 2}),
              (700, 8, {"J": 4})]
SPEC_CASES = {
    "default": dict(m=6, conditioning="mra"),
    "firstm": dict(m=6, conditioning="firstm"),
    "fullscale": dict(m=8, conditioning="mra", mra_options={"M": 1}),
    "lowrank": dict(m=8, conditioning="mra", mra_options={"r": [8, 1]}),
    "indep": dict(m=8, conditioning="mra", mra_options={"r": [0, 8]}),
    "J4": dict(m=8, conditioning="mra", mra_options={"J": 4}),
}


def _data(n=64, seed=1988, covparms=COVPARMS):
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    K = matern_np(cdist(locs, locs), covparms)
    z = rng.multivariate_normal(np.zeros(n), K + NUG * np.eye(n))
    return locs, z


def _specs(locs, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GT.vecchia_specify(locs, **kw), GJ.vecchia_specify(locs, **kw)


def _assert_spec_equal(a, b):
    for f in SPEC_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for f in ("ordering_pred", "cond_yz", "conditioning", "ic0", "n_obs",
              "n_pred", "mra_eff_m"):
        assert getattr(a, f) == getattr(b, f), f


# ------------------------------------------------------------ host ----

@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "python"])
@pytest.mark.parametrize("n,m,opts", TREE_CASES,
                         ids=[f"n{c[0]}" for c in TREE_CASES])
def test_mra_nnarray_matches_jax(n, m, opts, force_python):
    """The port's knot tree (the native one and its Python twin) gives the
    JAX package's NNarray and effective parameters."""
    assert host.native_loaded()
    locs = np.random.default_rng(41 + n).uniform(size=(n, 2))
    p = TMRA.get_mra_params(n, opts, m)
    assert p == JMRA.get_mra_params(n, opts, m)
    NN_t, eff_t = TMRA.build_mra_nnarray(locs, p["J"], p["M"], p["r"],
                                         force_python=force_python)
    NN_j, eff_j = JMRA.build_mra_nnarray(locs, p["J"], p["M"], p["r"],
                                         force_python=True)
    np.testing.assert_array_equal(NN_t, NN_j)
    assert eff_t == eff_j


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_mra_spec_matches_jax(case):
    locs, _ = _data(n=300, seed=5)
    st, sj = _specs(locs, **SPEC_CASES[case])
    _assert_spec_equal(st, sj)
    assert st.conditioning == "mra" and st.cond_yz == "y"


def test_mra_forces_maxmin_ordering():
    locs, _ = _data(n=80, seed=6)
    with pytest.warns(UserWarning, match="required 'maxmin'"):
        st = GT.vecchia_specify(locs, m=6, conditioning="mra",
                                ordering="coord")
    _, sj = _specs(locs, m=6, conditioning="mra", ordering="coord")
    _assert_spec_equal(st, sj)


def test_sel_pair_slots_match_jax():
    locs, _ = _data(n=90, seed=7)
    st, sj = _specs(locs, m=6, conditioning="mra")
    np.testing.assert_array_equal(get_sel_pair_slots(st),
                                  jax_sel_pair_slots(sj))
    # a nearest-neighbour pattern is not hierarchically closed
    st, sj = _specs(locs, m=6)
    with pytest.warns(UserWarning, match="hierarchically closed"):
        slots = get_sel_pair_slots(st)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(slots, jax_sel_pair_slots(sj))


@pytest.mark.parametrize("conditioning", ["mra", "NN"])
def test_packed_sel_pair_slots_are_the_upper_triangle(conditioning):
    """The packed slots the likelihood gathers by, built in row chunks from
    the upper-triangle pairs alone, equal the upper triangle of the JAX
    package's (n, m+1, m+1) table."""
    locs, _ = _data(n=90, seed=7)
    st, sj = _specs(locs, m=6, conditioning=conditioning)
    iu, ju = np.triu_indices(st.NNarray.shape[1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_sel_pair_slots(sj)[:, iu, ju]
        np.testing.assert_array_equal(sel_pair_slots_packed(st), want)
        np.testing.assert_array_equal(
            _sel_slot_table(st, iu, ju, chunk_rows=16), want)


def test_get_mat_cov_matches_jax():
    """The four sources of tests/test_mra.py's getMatCov check, through the
    port and the JAX package."""
    locs, _ = _data(n=16)
    st, sj = _specs(locs, m=3, conditioning="mra")
    cp = (0.5, 0.15, 0.5)
    Sigma = matern_np(cdist(st.locsord, st.locsord), cp)
    L = np.linalg.cholesky(Sigma)
    sources = [(L, True), (lambda D: matern_np(D, cp), False),
               (Sigma, False), (sp.csr_matrix(L), True)]
    ours = [get_mat_cov(st, s, factor=f) for s, f in sources]
    for (s, f), got in zip(sources, ours):
        np.testing.assert_array_equal(got, jax_get_mat_cov(sj, s, factor=f))
    for got in ours:
        np.testing.assert_allclose(np.nan_to_num(got),
                                   np.nan_to_num(ours[2]), atol=1e-10)


def test_mra_spec_loads_from_jax(tmp_path):
    """``from_jax_spec`` and ``load_spec`` of a JAX MRA spec give the port's
    own spec and its log-likelihood."""
    locs, z = _data(n=70, seed=8)
    st, sj = _specs(locs, m=6, conditioning="mra")
    path = tmp_path / "mra.npz"
    save_spec(sj, path)
    want = GT.vecchia_likelihood(z, st, COVPARMS, NUG, device="cpu")
    for spec in (from_jax_spec(sj), load_spec(path)):
        _assert_spec_equal(spec, sj)
        assert GT.vecchia_likelihood(z, spec, COVPARMS, NUG,
                                     device="cpu") == want


# ----------------------------------------------------- likelihood ----

@pytest.mark.parametrize("case", ["default", "firstm", "fullscale",
                                  "lowrank", "indep"])
def test_mra_loglik_matches_jax_and_dense(case):
    locs, z = _data(n=60)
    st, sj = _specs(locs, **SPEC_CASES[case])
    ll = GT.vecchia_likelihood(z, st, COVPARMS, NUG, device="cpu")
    llj = GJ.vecchia_likelihood(z, sj, COVPARMS, NUG)
    np.testing.assert_allclose(ll, llj, rtol=REL)
    np.testing.assert_allclose(ll, dense_loglik(z, sj, COVPARMS, NUG),
                               rtol=REL)


def test_firstm_equals_lowrank_mra():
    """GPvecchia tests/test-mra-firstm-equivalent.r, through the port."""
    locs, z = _data(n=50)
    st_f, _ = _specs(locs, m=6, conditioning="firstm")
    st_m, _ = _specs(locs, m=6, conditioning="mra", mra_options={"r": [6, 1]})
    np.testing.assert_allclose(
        GT.vecchia_likelihood(z, st_f, COVPARMS, NUG, device="cpu"),
        GT.vecchia_likelihood(z, st_m, COVPARMS, NUG, device="cpu"),
        atol=1e-9)


@pytest.mark.parametrize("covparms", [(1.0, 0.3, 0.5), (1.0, 0.3, 0.8)],
                         ids=["nu0.5", "nu0.8"])
def test_mra_gradient_matches_jax(covparms):
    """torch.autograd through the port vs jax.grad, in (covparms, nugget),
    at a closed-form and at a general smoothness."""
    locs, z = _data(n=80, seed=9)
    st, sj = _specs(locs, m=6, conditioning="mra")
    fj = GJ.loglik_fn(sj)
    gj = jax.grad(lambda c, g: fj(jnp.asarray(z), c, g), argnums=(0, 1))(
        jnp.asarray(covparms), jnp.asarray(0.1))
    c = torch.tensor(covparms, requires_grad=True)
    g = torch.tensor(0.1, requires_grad=True)
    ll = GT.loglik_fn(st, device="cpu")(torch.as_tensor(z), c, g)
    got = torch.autograd.grad(ll, (c, g))
    ref = [np.asarray(a) for a in gj]
    scale = max(np.abs(r).max() for r in ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_REL * scale)


# ------------------------------------------ covariance-model types ----

def test_covmodel_argument_types_agree():
    """GPvecchia tests/test-covmodel-argument-types.r:41-62 (as
    tests/test_mra.py): 'matern', the full Sigma and the selected matrix
    give one log-likelihood and one prediction mean through the port, and
    each equals the JAX package's."""
    locs, z = _data(n=36)
    st, sj = _specs(locs, m=4, conditioning="mra")
    Sigma = matern_np(cdist(st.locsord, st.locsord), COVPARMS)
    sel = get_mat_cov(st, Sigma)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lls, mus = [], []
        for cm in ("matern", Sigma, sel):
            lls.append(GT.vecchia_likelihood(z, st, COVPARMS, NUG, cm,
                                             device="cpu"))
            mus.append(GT.vecchia_prediction(
                z, st, COVPARMS, NUG, covmodel=cm, return_values="mean",
                device="cpu")["mu_obs"])
            np.testing.assert_allclose(
                lls[-1], GJ.vecchia_likelihood(z, sj, COVPARMS, NUG, cm),
                rtol=REL)
            np.testing.assert_allclose(
                mus[-1], jax_prediction(z, sj, COVPARMS, NUG, covmodel=cm,
                                        return_values="mean")["mu_obs"],
                rtol=0, atol=MEAN_ATOL)
    for ll, mu in zip(lls[1:], mus[1:]):
        np.testing.assert_allclose(ll, lls[0], atol=1e-9)
        np.testing.assert_allclose(mu, mus[0], atol=MEAN_ATOL)


def test_selected_layout_nugget_gradient():
    """The selected layout's nugget gradient (the covparms do not enter)
    equals the built-in Matern's at the same covariance, and jax.grad's."""
    locs, z = _data(n=50, seed=10)
    st, sj = _specs(locs, m=5, conditioning="mra")
    sel = get_mat_cov(st, matern_np(cdist(st.locsord, st.locsord), COVPARMS))
    grads = []
    for cm, cp in (("matern", COVPARMS), (sel, ())):
        g = torch.tensor(0.1, requires_grad=True)
        ll = GT.loglik_fn(st, cm, device="cpu")(
            torch.as_tensor(z), torch.tensor(cp), g)
        grads.append(float(torch.autograd.grad(ll, g)[0]))
    fj = GJ.loglik_fn(sj, sel)
    gj = float(jax.grad(lambda g: fj(jnp.asarray(z), jnp.zeros(0), g))(
        jnp.asarray(0.1)))
    np.testing.assert_allclose(grads[1], grads[0], rtol=GRAD_REL)
    np.testing.assert_allclose(grads[1], gj, rtol=GRAD_REL)


def test_selected_layout_cache_tells_matrices_apart():
    """Two selected matrices of one spec give their own values (the cache
    keys on the whole content)."""
    locs, z = _data(n=40, seed=11)
    st, _ = _specs(locs, m=4, conditioning="mra")
    D = cdist(st.locsord, st.locsord)
    a = get_mat_cov(st, matern_np(D, (1.0, 0.3, 0.5)))
    b = get_mat_cov(st, matern_np(D, (1.0, 0.5, 0.5)))
    lla = GT.vecchia_likelihood(z, st, (), NUG, a, device="cpu")
    llb = GT.vecchia_likelihood(z, st, (), NUG, b, device="cpu")
    ref = [GT.vecchia_likelihood(z, st, (1.0, r, 0.5), NUG, device="cpu")
           for r in (0.3, 0.5)]
    np.testing.assert_allclose([lla, llb], ref, rtol=REL)


# --------------------------------------------------- Vecchia-Laplace ----

@pytest.mark.parametrize("model", ["logistic", "poisson"])
def test_vl_on_mra_spec_matches_jax(model):
    """calculate_posterior_VL on an MRA spec (GPvecchia
    tests/test-VL-mra.r's setting) against the JAX package."""
    rng = np.random.default_rng(1989)
    n = 100
    locs = rng.uniform(size=(n, 2))
    y = rng.multivariate_normal(np.zeros(n), matern_np(cdist(locs, locs),
                                                       (1.0, 0.3, 0.5)))
    z = (rng.binomial(1, 1 / (1 + np.exp(-y))) if model == "logistic"
         else rng.poisson(np.exp(y))).astype(float)
    st, sj = _specs(locs, m=8, conditioning="mra")
    got = GT.calculate_posterior_VL(z, st, model, (1.0, 0.3, 0.5),
                                    device="cpu")
    want = JL.calculate_posterior_VL(z, sj, model, (1.0, 0.3, 0.5))
    assert (got["iter"], got["cnvgd"]) == (want["iter"], want["cnvgd"])
    assert got["cnvgd"]
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["D"], want["D"], rtol=1e-8)


def test_mra_with_obspred_prediction_points_raises():
    """An MRA spec with prediction points in the obspred ordering runs the
    per-entry V engine's obspred mode: the likelihood and the prediction
    (exact prediction variances included) match the JAX package."""
    locs, z = _data(n=60, seed=12)
    lp = np.random.default_rng(13).uniform(size=(10, 2))
    st, sj = _specs(locs, m=6, conditioning="mra", locs_pred=lp)
    _assert_spec_equal(st, sj)
    assert st.ordering_pred == "obspred"
    ll = GT.vecchia_likelihood(z, st, COVPARMS, NUG, device="cpu")
    assert abs(ll - GJ.vecchia_likelihood(z, sj, COVPARMS, NUG)) \
        <= REL * abs(ll)
    got = GT.vecchia_prediction(z, st, COVPARMS, NUG, device="cpu")
    want = jax_prediction(z, sj, COVPARMS, NUG)
    for k in ("mu_obs", "mu_pred", "var_obs", "var_pred"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=MEAN_ATOL * np.max(np.abs(want[k])),
                                   err_msg=k)
