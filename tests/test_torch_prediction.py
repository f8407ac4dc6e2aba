"""The port's posterior through the multifrontal factor vs the JAX package
and the dense reference, on the CPU in float64.

``mf_forward`` / ``mf_backward`` / ``mf_solve`` / ``mf_selinv_diag`` on
random element sets against the JAX functions and a dense W;
``vecchia_prediction`` (means and selected-inverse variances) against the
JAX package's and ``reference_impl.dense_posterior`` on 'chol'-mode specs;
``vecchia_lincomb`` and ``V2covmat`` on the kept factor; and prediction on
the per-entry V engine's specs (obspred, zy, IC0) and ``vecchia_pred``'s
default spec.  Inputs are made with numpy from a seed.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scipy.spatial.distance import cdist

from gpvecchia_tpu.inference.likelihood import \
    zero_nugget_variant as jax_zero_nugget_variant
from gpvecchia_tpu.inference.prediction import V2covmat as jax_V2covmat
from gpvecchia_tpu.inference.prediction import vecchia_lincomb as jax_lincomb
from gpvecchia_tpu.inference.prediction import \
    vecchia_prediction as jax_prediction
from gpvecchia_tpu.linalg import multifrontal as JM
from gpvecchia_tpu.spec import VecchiaSpec as JaxSpec

import gpvecchia_torch as GT
from gpvecchia_torch.inference.likelihood import zero_nugget_variant
from gpvecchia_torch.inference.prediction import V2covmat, vecchia_lincomb
from gpvecchia_torch.linalg import multifrontal as MF
from gpvecchia_torch.linalg.mf_plan import build_mf_plan

from reference_impl import dense_posterior, matern_np
from test_multifrontal import _dense_W, _random_elements

REL = 1e-9
COVPARMS = (1.0, 0.3, 0.5)
NUG = 0.2


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def jax_spec(spec):
    """The port's spec as the JAX package's (the same arrays)."""
    return JaxSpec(**{f.name: getattr(spec, f.name)
                      for f in dataclasses.fields(JaxSpec)
                      if not f.name.startswith("_")})


# ------------------------------------------------------ factor solves ----

@pytest.fixture(scope="module", params=[(60, 5, 8), (300, 9, 512)],
                ids=["depth3", "root_only"])
def factors(request):
    """(port factor, JAX static/arrays/factor, dense W, b, rng) on random
    Vecchia-like elements; the port's kept fronts get NaN in their strict
    upper triangles, which nothing may read."""
    n_vert, K, leaf = request.param
    rng = np.random.default_rng(1988 + n_vert + leaf)
    ev, xy, u = _random_elements(rng, n_vert, K)
    dvec = rng.uniform(1.0, 3.0, size=n_vert) + 5.0 * K
    W = _dense_W(ev, u, dvec, n_vert)
    re_, rv = rng.normal(size=n_vert), rng.normal(size=n_vert)
    mf = build_mf_plan(ev, xy, n_vert, leaf_elems=leaf)
    fac = MF.mf_factor_keep(MF.mf_device_arrays(mf, "cpu"), _t(u), _t(dvec),
                            _t(re_), _t(rv))
    static, arrays = JM.mf_device_arrays(mf, fused=False)
    jfac = jax.jit(lambda a, *v: JM.mf_factor(
        static, a, v[0], v[1], rhs_elem=v[2], rhs_vert=v[3]))(
        arrays, *(jnp.asarray(a) for a in (u, dvec, re_, rv)))
    for f in fac.fronts:
        F1 = f.shape[1]
        iu = torch.triu_indices(F1, F1, 1)
        f[:, iu[0], iu[1]] = torch.nan
    b = rv.copy()
    for e in range(ev.shape[0]):
        ok = ev[e] >= 0
        b[ev[e][ok]] += re_[e] * u[e][ok]
    return fac, (static, arrays, jfac), W, b, rng


def test_kept_factor_matches_jax(factors):
    """logdet, quad and each level's L_pp, L_bp and y of the kept factor."""
    fac, (_, _, jfac), _, _, _ = factors
    np.testing.assert_allclose(float(fac.logdet), float(jfac["logdet"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(fac.quad), float(jfac["quad"]),
                               rtol=1e-11)
    for d in range(len(fac.fronts)):
        assert not torch.isnan(fac.L_pp(d)).any()
        for got, key in ((fac.L_pp(d), "L_pp"), (fac.L_bp(d), "L_bp"),
                         (fac.y(d), "y")):
            want = np.asarray(jfac[key][d])
            if want.size:
                assert _rel(got.numpy(), want) <= 1e-12


def test_mf_backward_matches_jax_and_dense(factors):
    fac, (static, arrays, jfac), W, b, _ = factors
    x = MF.mf_backward(fac).numpy()
    want = jax.jit(lambda a, f: JM.mf_backward(static, a, f))(arrays, jfac)
    assert _rel(x, np.asarray(want)) <= REL
    assert _rel(x, np.linalg.solve(W, b)) <= REL


def test_mf_solve_matches_jax_and_dense(factors):
    """One right-hand side, and three at once."""
    fac, (static, arrays, jfac), W, _, rng = factors
    c = rng.normal(size=(W.shape[0], 3))
    x1 = MF.mf_solve(fac, _t(c[:, 0])).numpy()
    want = jax.jit(lambda a, f, r: JM.mf_solve(static, a, f, r))(
        arrays, jfac, jnp.asarray(c[:, 0]))
    assert _rel(x1, np.asarray(want)) <= REL
    x3 = MF.mf_solve(fac, _t(c)).numpy()
    assert _rel(x3, np.linalg.solve(W, c)) <= REL
    ys, quad = MF.mf_forward(fac, _t(c[:, 0]))
    jys, jquad = jax.jit(lambda a, f, r: JM.mf_forward(static, a, f, r))(
        arrays, jfac, jnp.asarray(c[:, 0]))
    np.testing.assert_allclose(float(quad), float(jquad), rtol=1e-12)
    for y, jy in zip(ys, jys):
        if y.numel():
            assert _rel(y.numpy(), np.asarray(jy)) <= REL


@pytest.mark.parametrize("leaf_chunks", [None, 4])
def test_mf_selinv_diag_matches_jax_and_dense(factors, leaf_chunks):
    fac, (static, arrays, jfac), W, _, _ = factors
    d = MF.mf_selinv_diag(fac, leaf_chunks=leaf_chunks).numpy()
    want = jax.jit(lambda a, f: JM.mf_selinv_diag(static, a, f))(arrays, jfac)
    assert _rel(d, np.asarray(want)) <= REL
    assert _rel(d, np.diag(np.linalg.inv(W))) <= REL


# --------------------------------------------------------- prediction ----

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1996)
    locs = rng.uniform(size=(150, 2))
    locs_pred = rng.uniform(size=(30, 2))
    z = rng.normal(size=150)
    return locs, locs_pred, z


SPECS = {
    "y": dict(cond_yz="y"), "z": dict(cond_yz="z"),
    "SGV": dict(cond_yz="SGV"), "SGVT": dict(cond_yz="SGVT"),
    "SGV_general_pred": dict(cond_yz="SGV", ordering_pred="general"),
    "y_general_pred": dict(cond_yz="y", ordering_pred="general"),
}


def _spec(data, name, m=10):
    locs, locs_pred, _ = data
    kw = dict(SPECS[name])
    if "ordering_pred" in kw:
        kw["locs_pred"] = locs_pred
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GT.vecchia_specify(locs, m=m, **kw)


def _check_prediction(spec, z, nug, covparms=COVPARMS):
    """The port's prediction vs the JAX package's and the dense reference."""
    got = GT.vecchia_prediction(z, spec, covparms, nug, device="cpu")
    sj = jax_spec(spec)
    want = jax_prediction(z, sj, covparms, nug)
    zf, nugf = z, np.broadcast_to(np.asarray(nug, float), z.shape)
    if np.isnan(z).any():
        nugf = np.where(np.isnan(z), np.nanvar(z, ddof=1) * 1e8, nugf)
        zf = np.where(np.isnan(z), np.nanmean(z), z)
    dense = dense_posterior(zf, jax_zero_nugget_variant(sj, nugf), covparms,
                            nugf)
    for k in ("mu_obs", "mu_pred", "var_obs", "var_pred"):
        assert got[k].shape == want[k].shape
        if got[k].size:
            assert _rel(got[k], want[k]) <= REL, k
            assert _rel(got[k], dense[k]) <= REL, k
    assert isinstance(got["V"], MF.MFFactor)
    return got


@pytest.mark.parametrize("name", list(SPECS))
def test_prediction_matches_jax_and_dense(data, name):
    spec = _spec(data, name)
    got = _check_prediction(spec, data[2], NUG)
    assert got["mu_pred"].size == (30 if "pred" in name else 0)


def test_general_pred_spec_conditions_unobserved_points_on_latents(data):
    """Under the general prediction ordering no point conditions on the
    response of a prediction point (the JAX package's SGV spec does, and
    its plan then refuses it)."""
    locs, locs_pred, _ = data
    for cond in ("SGV", "SGVT", "z"):
        spec = GT.vecchia_specify(locs, m=10, locs_pred=locs_pred,
                                  cond_yz=cond, ordering_pred="general")
        NN = spec.NNarray
        valid = NN >= 0
        resp = valid & ~spec.cond_latent
        assert spec.has_obs[np.where(valid, NN, 0)][resp].all()


def test_vector_nuggets_and_na_match_jax(data):
    spec = _spec(data, "SGV_general_pred")
    z = data[2].copy()
    z[[3, 17, 90]] = np.nan
    nug = np.linspace(0.1, 0.4, z.size)
    got = _check_prediction(spec, z, nug)
    assert np.all(np.isfinite(got["mu_obs"]))


def test_zero_nuggets_match_jax(data):
    """Exact observations: mean = datum, variance 0."""
    spec = _spec(data, "SGV")
    z = data[2]
    nug = np.full(z.size, NUG)
    nug[[0, 5, 40]] = 0.0
    got = _check_prediction(spec, z, nug)
    np.testing.assert_array_equal(got["mu_obs"][[0, 5, 40]], z[[0, 5, 40]])
    np.testing.assert_array_equal(got["var_obs"][[0, 5, 40]], 0.0)


@pytest.fixture(scope="module")
def lincomb_case(data):
    spec = _spec(data, "y_general_pred", m=12)
    pred = GT.vecchia_prediction(data[2], spec, COVPARMS, NUG, device="cpu")
    sj = jax_spec(spec)
    jpred = jax_prediction(data[2], sj, COVPARMS, NUG)
    return spec, sj, pred["V"], jpred["V"]


def test_lincomb_matches_jax(lincomb_case):
    spec, sj, V, jV = lincomb_case
    rng = np.random.default_rng(5)
    H = rng.normal(size=(4, spec.ord.size))
    for cov_mat in (False, True):
        got = vecchia_lincomb(H, spec, V, cov_mat=cov_mat)
        assert _rel(got, jax_lincomb(H, sj, jV, cov_mat=cov_mat)) <= REL


def test_V2covmat_matches_jax_and_the_variances(lincomb_case, data):
    spec, sj, V, jV = lincomb_case
    got = V2covmat(spec, V)
    want = jax_V2covmat(sj, jV)
    pred = GT.vecchia_prediction(data[2], spec, COVPARMS, NUG, device="cpu")
    for k, var in (("Sigma_obs", "var_obs"), ("Sigma_pred", "var_pred")):
        assert _rel(got[k], want[k]) <= REL
        assert _rel(np.diag(got[k]), pred[var]) <= REL


def test_lincomb_with_known_points_raises(data):
    """The reference's own rule: a factor built under the zero-nugget
    variant has no column for a known point (ROADMAP, known reference
    faults); the port raises as the JAX package does."""
    spec = _spec(data, "SGV")
    nug = np.full(data[2].size, NUG)
    nug[[2, 9]] = 0.0
    V = GT.vecchia_prediction(data[2], spec, COVPARMS, nug,
                              return_values="meanmat", device="cpu")["V"]
    variant = zero_nugget_variant(spec, nug)
    H = np.ones((1, spec.ord.size))
    with pytest.raises(NotImplementedError, match="all latents free"):
        vecchia_lincomb(H, variant, V)
    with pytest.raises(ValueError, match="does not match"):
        vecchia_lincomb(H, spec, V)


@pytest.mark.parametrize("case", ["obspred", "zy", "ic0", "per_entry_V"])
def test_unported_paths_raise(data, case):
    """The paths that raised before the per-entry V engine was ported now
    match the JAX package: prediction on obspred SGV, zy and IC0 specs (the
    exact prediction variances of obspred specs included), and
    ``vecchia_lincomb`` / ``V2covmat`` on a per-entry V factor."""
    locs, locs_pred, z = data
    locs, locs_pred, z = locs[:60], locs_pred[:10], z[:60]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "obspred":
            spec = GT.vecchia_specify(locs, m=5, locs_pred=locs_pred,
                                      cond_yz="SGV", ordering_pred="obspred")
        elif case in ("zy", "per_entry_V"):
            spec = GT.vecchia_specify(locs, m=5, cond_yz="zy",
                                      locs_pred=locs_pred)
        else:
            spec = GT.vecchia_specify(locs, m=5, ic0=True)
        got = GT.vecchia_prediction(z, spec, COVPARMS, NUG, device="cpu")
        want = jax_prediction(z, jax_spec(spec), COVPARMS, NUG)
    if case == "per_entry_V":
        sj = jax_spec(spec)
        H = np.random.default_rng(3).normal(size=(2, spec.ord.size))
        H[:, :spec.n_obs] = 0.0
        Sp = jax_V2covmat(sj, want["V"])["Sigma_pred"]
        Hp = H[:, spec.n_obs:]
        assert _rel(vecchia_lincomb(H, spec, got["V"], cov_mat=True),
                    Hp @ Sp @ Hp.T) <= REL
        assert _rel(V2covmat(spec, got["V"])["Sigma_pred"], Sp) <= REL
        return
    for k in ("mu_obs", "mu_pred", "var_obs", "var_pred"):
        if want[k] is not None and np.size(want[k]):
            assert _rel(got[k], want[k]) <= REL, k


def test_vecchia_pred_matches_jax(data):
    """Prediction with an estimate (its trend added back), on the default
    spec (zy with the obspred ordering: the per-entry V factor's direct
    mode, exact prediction variances) and on a multifrontal one."""
    from gpvecchia_tpu.fit.mle import vecchia_pred as jax_vecchia_pred
    from gpvecchia_torch.fit.mle import vecchia_pred
    locs, locs_pred, z = data
    est = dict(z=z, locs=locs, theta_hat=np.array([1.0, 0.3, 0.5, NUG]),
               covmodel="matern", trend="constant", beta_hat=np.array([2.0]))
    for kw in (dict(cond_yz="y", ordering_pred="general"), {}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = vecchia_pred(est, locs_pred, m=10, device="cpu", **kw)
            want = jax_vecchia_pred(est, locs_pred, m=10, **kw)
        for k in ("mean_pred", "var_pred"):
            assert _rel(got[k], want[k]) <= REL, (kw, k)


def test_pred_cache_tells_matrices_apart(data):
    """Two full matrices that print alike give different posteriors on one
    spec (the JAX package keys its prediction cache on str(covmodel))."""
    locs, _, z = data
    spec = GT.vecchia_specify(locs[:60], m=8)
    A = matern_np(cdist(spec.locsord, spec.locsord), (1.0, 0.3, 0.8))
    B = A.copy()
    B[10:50, 10:50] += 0.2 * np.eye(40)
    assert str(A) == str(B)
    mu_a = GT.vecchia_prediction(z[:60], spec, (), 0.1, covmodel=A,
                                 device="cpu")["mu_obs"]
    mu_b = GT.vecchia_prediction(z[:60], spec, (), 0.1, covmodel=B,
                                 device="cpu")["mu_obs"]
    fresh = GT.vecchia_specify(locs[:60], m=8)
    mu_b_fresh = GT.vecchia_prediction(z[:60], fresh, (), 0.1, covmodel=B,
                                       device="cpu")["mu_obs"]
    assert np.max(np.abs(mu_a - mu_b)) > 1e-3
    np.testing.assert_allclose(mu_b, mu_b_fresh, rtol=1e-13)


def test_prediction_defaults_to_the_card(data):
    """Without a visible CUDA device the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    spec = _spec(data, "SGV")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GT.vecchia_prediction(data[2], spec, COVPARMS, NUG)
