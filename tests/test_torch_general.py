"""The general covariances on the port's likelihood path vs the JAX package.

The port (``device="cpu"``, float64) against the JAX ``vecchia_likelihood``
and ``jax.grad`` (x64): the Matern at general smoothness, ``esqe``, a
distance callable, a location-pair callable and a full covariance matrix,
all through ``build_cov_packed`` and H8's plain version.  Also the
cross-path check (the closed-form Matern as a user callable takes H8's path
and must equal the built-in H1 path), the covariance-matrix cache key, the
selected-matrix layout on an MRA spec, and the default device.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

import jax
import jax.numpy as jnp

import gpvecchia_tpu as GJ
from gpvecchia_tpu.inference.likelihood import \
    zero_nugget_variant as jax_zero_variant

import gpvecchia_torch as GT
from gpvecchia_torch.hv import get_mat_cov
from gpvecchia_torch.inference.likelihood import zero_nugget_variant
from gpvecchia_torch.kernels import matern_solve as MS

from reference_impl import matern_np

torch.set_default_dtype(torch.float64)

REL = 1e-10          # log-likelihood, relative
GRAD_REL = 1e-9      # gradient in (sig2, rho, nuggets), of |g|max
DNU_REL = 1e-6       # d/dnu: both sides divide log K_nu rounding by 2h


def _data(n=150, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, 2)), rng.normal(size=n)


def _exp_t(dist, covparms):
    return covparms[0] * torch.exp(-dist / covparms[1])


def _exp_j(dist, covparms):
    return covparms[0] * jnp.exp(-dist / covparms[1])


def _locs_t(locs1, locs2, covparms):
    d2 = ((locs1 - locs2) ** 2).sum(-1)
    return covparms[0] * torch.exp(-torch.sqrt(d2 + 1e-300) / covparms[1])


def _locs_j(locs1, locs2, covparms):
    d2 = jnp.sum((locs1 - locs2) ** 2, -1)
    return covparms[0] * jnp.exp(-jnp.sqrt(d2 + 1e-300) / covparms[1])


def _covmat(spec, covparms):
    return matern_np(cdist(spec.locsord, spec.locsord), covparms)


# (covmodel for the port, for the JAX package, covparms)
CASES = {
    "nu0.3": ("matern", "matern", (1.0, 0.2, 0.3)),
    "nu0.8": ("matern", "matern", (1.0, 0.2, 0.8)),
    "nu2.0": ("matern", "matern", (1.0, 0.2, 2.0)),
    "esqe": ("esqe", "esqe", (0.8, 0.3, 0.4, 0.2)),
    "dist_callable": (_exp_t, _exp_j, (1.0, 0.2)),
    "locs_callable": (_locs_t, _locs_j, (1.0, 0.2)),
}


def _both(locs, z, case, nug, m=10, cond="SGV"):
    cm_t, cm_j, cp = CASES[case]
    st = GT.vecchia_specify(locs, m=m, cond_yz=cond)
    sj = GJ.vecchia_specify(locs, m=m, cond_yz=cond)
    return (GT.vecchia_likelihood(z, st, cp, nug, cm_t, device="cpu"),
            GJ.vecchia_likelihood(z, sj, cp, nug, cm_j))


@pytest.mark.parametrize("case", list(CASES))
def test_likelihood_matches_jax(case):
    locs, z = _data()
    ll_t, ll_j = _both(locs, z, case, 0.1)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


@pytest.mark.parametrize("case", ["nu0.8", "esqe"])
def test_vector_nuggets_and_na_match_jax(case):
    locs, z = _data(seed=1)
    z[[4, 30]] = np.nan
    ll_t, ll_j = _both(locs, z, case, np.linspace(0.05, 0.2, len(z)))
    assert np.isfinite(ll_t)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


@pytest.mark.parametrize("case", ["nu0.8", "locs_callable"])
def test_zero_nugget_matches_jax(case):
    locs, z = _data(seed=2)
    nug = np.full(len(z), 0.1)
    nug[[0, 7, 60]] = 0.0
    ll_t, ll_j = _both(locs, z, case, nug)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)


def test_full_covmat_matches_jax():
    locs, z = _data(seed=3)
    st = GT.vecchia_specify(locs, m=10)
    sj = GJ.vecchia_specify(locs, m=10)
    C = _covmat(st, (1.0, 0.2, 0.8))
    np.testing.assert_array_equal(st.locsord, sj.locsord)
    ll_t = GT.vecchia_likelihood(z, st, (), 0.1, C, device="cpu")
    ll_j = GJ.vecchia_likelihood(z, sj, (), 0.1, C)
    np.testing.assert_allclose(ll_t, ll_j, rtol=REL)
    # the same covariance as a kernel gives the same log-likelihood
    ll_k = GT.vecchia_likelihood(z, st, (1.0, 0.2, 0.8), 0.1, device="cpu")
    np.testing.assert_allclose(ll_t, ll_k, rtol=1e-9)


def _grads(locs, z, case, nug, m=8):
    """(port, jax) gradients of the log-likelihood in (covparms, nuggets)."""
    cm_t, cm_j, cp = CASES[case]
    nug = np.asarray(nug, np.float64)
    nug_b = np.broadcast_to(nug, (len(z),))
    st = zero_nugget_variant(GT.vecchia_specify(locs, m=m), nug_b)
    sj = jax_zero_variant(GJ.vecchia_specify(locs, m=m), nug_b)
    fj = GJ.loglik_fn(sj, cm_j)
    gj = jax.grad(lambda c, g: fj(jnp.asarray(z), c, g), argnums=(0, 1))(
        jnp.asarray(cp, jnp.float64), jnp.asarray(nug))
    c = torch.tensor(cp, dtype=torch.float64, requires_grad=True)
    g = torch.tensor(nug, dtype=torch.float64, requires_grad=True)
    ll = GT.loglik_fn(st, cm_t, device="cpu")(torch.as_tensor(z), c, g)
    gt = torch.autograd.grad(ll, (c, g))
    return [a.numpy() for a in gt], [np.asarray(a) for a in gj]


@pytest.mark.parametrize("case,vector", [("nu0.8", False), ("nu0.8", True),
                                         ("esqe", False),
                                         ("locs_callable", True)])
def test_grad_matches_jax(case, vector):
    """(sig2, rho, ...) and the nuggets to 1e-9 of |g|max; d/dnu 1e-6
    relative (a central difference over 2h = 6e-6 on both sides)."""
    locs, z = _data(n=120, seed=4)
    nug = np.linspace(0.05, 0.15, len(z)) if vector else 0.1
    ours, ref = _grads(locs, z, case, nug)
    scale = max(np.abs(r).max() for r in ref)
    is_matern = CASES[case][0] == "matern"
    par = slice(0, 2) if is_matern else slice(None)
    np.testing.assert_allclose(ours[0][par], ref[0][par], rtol=0,
                               atol=GRAD_REL * scale)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=GRAD_REL * scale)
    if is_matern:
        assert ours[0][2] != 0.0
        np.testing.assert_allclose(ours[0][2], ref[0][2], rtol=DNU_REL)


def test_grad_zero_nuggets_and_na_match_jax():
    locs, z = _data(n=100, seed=5)
    z[[2, 50]] = np.nan
    nug = np.full(len(z), 0.1)
    nug[[0, 9]] = 0.0
    ours, ref = _grads(locs, z, "nu0.8", nug, m=6)
    scale = max(np.abs(r).max() for r in ref)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=GRAD_REL * scale)
    np.testing.assert_allclose(ours[0][:2], ref[0][:2], rtol=0,
                               atol=GRAD_REL * scale)
    np.testing.assert_allclose(ours[0][2], ref[0][2], rtol=DNU_REL)


def _exp05(dist, covparms):
    """The Matern at smoothness 0.5 as a user callable."""
    return covparms[0] * torch.exp(-dist / covparms[1])


def test_callable_path_equals_builtin_matern_path(monkeypatch):
    """The closed form nu = 0.5 passed as a user callable takes H8's path
    (build_cov_packed + solve_e0, backward solve_e0_bwd); its value and
    (sig2, rho, nugget) gradient equal the built-in 'matern' path (H1)."""
    calls = {"solve_e0": 0, "solve_e0_bwd": 0, "matern_solve_e0": 0}
    for name in calls:
        def spy(*a, _fn=getattr(MS, name + "_plain"), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(MS, name + "_plain", spy)
    locs, z = _data(n=300, seed=6)
    spec = GT.vecchia_specify(locs, m=10)
    out = {}
    for cm in ("matern", _exp05):
        c = torch.tensor([1.2, 0.15, 0.5], requires_grad=True)
        g = torch.tensor(0.1, requires_grad=True)
        ll = GT.loglik_fn(spec, cm, device="cpu")(torch.as_tensor(z), c, g)
        dc, dg = torch.autograd.grad(ll, (c, g))
        out[cm if isinstance(cm, str) else "callable"] = (
            ll.item(), dc[:2].numpy(), dg.item())
    assert calls["solve_e0"] > 0 and calls["solve_e0_bwd"] > 0
    assert calls["matern_solve_e0"] > 0
    a, b = out["matern"], out["callable"]
    np.testing.assert_allclose(b[0], a[0], rtol=1e-10)
    np.testing.assert_allclose(b[1], a[1], rtol=1e-10)
    np.testing.assert_allclose(b[2], a[2], rtol=1e-10)


def _poisoned_rows(kernel_fn):
    """u_entries at smoothness 0.8 with one response nugget of -1e3 (every
    conditioning matrix that holds it is not SPD) through ``kernel_fn``:
    the bad rows are dropped, and the gradient (the backward kernels give a
    zero cotangent row a zero contribution) is finite and equals jax.grad
    over the other rows."""
    from gpvecchia_tpu.kernels.covariance import matern as jax_matern
    from gpvecchia_tpu.kernels.u_entries import u_entries as jax_u_entries
    from gpvecchia_torch.kernels.u_entries import u_entries
    from gpvecchia_torch.plan import get_plan
    locs, _ = _data(n=300, seed=10)
    plan = get_plan(GT.vecchia_specify(locs, m=8))
    nug = np.full(plan.n_all, 0.15)
    nug[plan.NN[plan.nb_resp][0]] = -1e3
    W = np.random.default_rng(1).normal(size=plan.NN.shape)
    cp = np.array([1.0, 0.2, 0.8])
    c = torch.tensor(cp, requires_grad=True)
    g = torch.tensor(nug, requires_grad=True)
    col, bad = u_entries(*(torch.as_tensor(a) for a in (
        plan.locs, plan.NN, plan.valid, plan.cond)), g, c, kernel_fn)
    assert bad.any()
    (torch.where(bad[:, None], 0.0, col) * torch.as_tensor(W)).sum().backward()
    good = ~bad.numpy()

    def fj(c, g):
        colj, _ = jax_u_entries(jnp.asarray(plan.locs),
                                jnp.asarray(plan.NN[good]),
                                jnp.asarray(plan.valid[good]),
                                jnp.asarray(plan.cond[good]), g, jax_matern, c)
        return jnp.sum(colj * W[good])

    ref = [np.asarray(r) for r in jax.grad(fj, argnums=(0, 1))(
        jnp.asarray(cp), jnp.asarray(nug))]
    scale = max(np.abs(r).max() for r in ref)
    np.testing.assert_allclose(c.grad[:2].numpy(), ref[0][:2], rtol=0,
                               atol=GRAD_REL * scale)
    np.testing.assert_allclose(g.grad.numpy(), ref[1], rtol=0,
                               atol=GRAD_REL * scale)
    np.testing.assert_allclose(c.grad[2].item(), ref[0][2], rtol=DNU_REL)


def test_poisoned_rows_on_the_packed_path(monkeypatch):
    """A non-SPD conditioning matrix on H8's path (the Matern passed as a
    callable): see ``_poisoned_rows``."""
    from gpvecchia_torch.kernels.covariance import matern
    calls = {"solve_e0_bwd": 0}
    fn = MS.solve_e0_bwd_plain

    def spy(*a):
        calls["solve_e0_bwd"] += 1
        return fn(*a)
    monkeypatch.setattr(MS, "solve_e0_bwd_plain", spy)
    _poisoned_rows(lambda dist, cp: matern(dist, cp))
    assert calls["solve_e0_bwd"] > 0


def test_poisoned_rows_on_the_fused_general_path(monkeypatch):
    """The same on the built-in Matern, whose general smoothness H1 and H5
    take: see ``_poisoned_rows``."""
    calls = {"bwd": 0}
    fn = MS.matern_solve_e0_bwd_plain

    def spy(*a):
        calls["bwd"] += 1
        return fn(*a)
    monkeypatch.setattr(MS, "matern_solve_e0_bwd_plain", spy)
    _poisoned_rows(None)
    assert calls["bwd"] == 1


# the built-in Matern at general smoothness, on H1 and H5's path: k = 0 ...
# 4 and mu of both signs, at a range that puts pairs on both sides of s = 3
# (Temme's series and CF2)
FUSED_NUS = [0.3, 0.8, 1.2, 2.0, 3.7]
FUSED_RANGE = 0.04


@pytest.fixture(scope="module")
def fused_specs():
    locs, z = _data(n=150, seed=8)
    nug = np.full(len(z), 0.1)
    st, sj = (GT.vecchia_specify(locs, m=8), GJ.vecchia_specify(locs, m=8))
    NN = st.NNarray
    ok = NN >= 0
    pts = st.locsord[np.where(ok, NN, 0)]
    dist = np.linalg.norm(pts[:, :, None] - pts[:, None, :], axis=-1)
    s = dist[ok[:, :, None] & ok[:, None, :]] / FUSED_RANGE
    assert (s > 3).any() and ((s > 0) & (s <= 3)).any()
    return z, nug, GT.loglik_fn(st, device="cpu"), GJ.loglik_fn(sj)


@pytest.mark.parametrize("nu", FUSED_NUS)
def test_fused_general_grad_matches_jax(fused_specs, nu, monkeypatch):
    """Value and gradient in (sig2, rho, nu, nugget) of the log-likelihood
    whose U entries H1 and H5 build at a general smoothness (their plain
    versions here) vs the JAX package's value and jax.grad: value 1e-10
    relative, (sig2, rho, nugget) 1e-8 of |g|max, d/dnu 1e-6 relative."""
    calls = {"packed": 0}
    fn = MS.solve_e0_plain

    def spy(*a):
        calls["packed"] += 1
        return fn(*a)
    monkeypatch.setattr(MS, "solve_e0_plain", spy)
    z, nug, ft, fj = fused_specs
    cp = np.array([1.0, FUSED_RANGE, nu])
    lj, gj = jax.value_and_grad(lambda c, g: fj(jnp.asarray(z), c, g),
                                argnums=(0, 1))(jnp.asarray(cp),
                                                jnp.asarray(nug))
    c = torch.tensor(cp, requires_grad=True)
    g = torch.tensor(nug, requires_grad=True)
    lt = ft(torch.as_tensor(z), c, g)
    dc, dg = torch.autograd.grad(lt, (c, g))
    assert calls["packed"] == 0
    np.testing.assert_allclose(lt.item(), float(lj), rtol=REL)
    ref = [np.asarray(a) for a in gj]
    scale = max(np.abs(ref[0][:2]).max(), np.abs(ref[1]).max())
    np.testing.assert_allclose(dc[:2].numpy(), ref[0][:2], rtol=0,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(dg.numpy(), ref[1], rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(dc[2].item(), ref[0][2], rtol=DNU_REL)


def test_covmat_cache_tells_matrices_apart():
    """Two full matrices that differ only in an interior block give
    different log-likelihoods on one spec (the JAX package keys its cache
    on str(covmodel), which abbreviates large matrices, and returns the
    first matrix's value for the second)."""
    locs, z = _data(n=60, seed=7)
    spec = GT.vecchia_specify(locs, m=8)
    A = _covmat(spec, (1.0, 0.3, 0.8))
    B = A.copy()
    B[10:50, 10:50] += 0.2 * np.eye(40)
    assert str(A) == str(B)
    ll_a = GT.vecchia_likelihood(z, spec, (), 0.1, A, device="cpu")
    ll_b = GT.vecchia_likelihood(z, spec, (), 0.1, B, device="cpu")
    fresh = GT.vecchia_specify(locs, m=8)
    ll_b_fresh = GT.vecchia_likelihood(z, fresh, (), 0.1, B, device="cpu")
    assert ll_a != ll_b
    np.testing.assert_allclose(ll_b, ll_b_fresh, rtol=1e-13)
    # an in-place change of the same matrix is seen too
    B[20, 20] += 0.5
    ll_b2 = GT.vecchia_likelihood(z, spec, (), 0.1, B, device="cpu")
    assert ll_b2 != ll_b


def test_selected_matrix_layout_raises():
    """The selected (n_all, m+1) layout, which this test once pinned as
    unported, gives the JAX package's value on an MRA spec; a matrix of
    neither layout's shape still raises."""
    locs, z = _data(n=40, seed=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec = GT.vecchia_specify(locs, m=5, conditioning="mra")
        sj = GJ.vecchia_specify(locs, m=5, conditioning="mra")
    sel = get_mat_cov(spec, _covmat(spec, (1.0, 0.3, 0.8)))
    ll = GT.vecchia_likelihood(z, spec, (), 0.1, sel, device="cpu")
    np.testing.assert_allclose(ll, GJ.vecchia_likelihood(z, sj, (), 0.1, sel),
                               rtol=REL)
    np.testing.assert_allclose(ll, GT.vecchia_likelihood(
        z, spec, (1.0, 0.3, 0.8), 0.1, device="cpu"), rtol=REL)
    with pytest.raises(ValueError, match="matches neither"):
        GT.vecchia_likelihood(z, spec, (), 0.1, np.ones((3, 3)),
                              device="cpu")


def test_entry_points_default_to_the_card():
    """Without a visible CUDA device the default device raises; it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    locs, z = _data(n=40, seed=9)
    spec = GT.vecchia_specify(locs, m=5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GT.vecchia_likelihood(z, spec, (1.0, 0.2, 0.5), 0.1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GT.loglik_fn(spec)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GT.vecchia_estimate(z, locs, m=5, output_level=0)
