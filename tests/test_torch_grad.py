"""The port's gradient of the log-likelihood in (covparms, nuggets), and the
backward of each kernel, vs the JAX package on the CPU.

* the slice: ``torch.autograd.grad`` of ``gpvecchia_torch.loglik_fn`` vs
  ``jax.grad`` of ``gpvecchia_tpu.loglik_fn`` in float64, to 1e-9 of the
  largest gradient entry (both are the same closed-form VJPs in another
  summation order; measured ~1e-15);
* H5 and ``solve_e0_bwd`` (K2), H6 (K8b and the ``dch`` of the level and
  assembly VJPs), H7 (the leaf VJP's ``du``) and ``front_factor_vjp`` (the
  ``factor_fronts`` VJP) through their plain versions vs the Pallas kernels
  and their VJPs in interpret mode, in float32 with tolerances stated per
  test; intermediate cotangents are compared after symmetrizing, as
  tests/test_pallas_level.py does;
* ``torch.autograd.gradcheck`` of both autograd Functions in float64.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrappers take the plain versions, so these tests run the
Functions' own backward (checked by counting the plain backward calls).
"""

import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.linalg

import gpvecchia_tpu as GJ
import gpvecchia_tpu.kernels.pallas_crout as pc
import gpvecchia_tpu.linalg.pallas_eadd as pe
import gpvecchia_tpu.linalg.pallas_frontal as pf
from gpvecchia_tpu.inference.likelihood import \
    zero_nugget_variant as jax_zero_variant
from gpvecchia_tpu.kernels.covariance import matern as jax_matern
from gpvecchia_tpu.kernels.u_entries import u_entries as jax_u_entries
from gpvecchia_tpu.linalg import pallas_level as PL

import gpvecchia_torch as GT
from gpvecchia_torch.inference.likelihood import zero_nugget_variant
from gpvecchia_torch.kernels import matern_solve as MS
from gpvecchia_torch.kernels.u_entries import u_entries
from gpvecchia_torch.linalg import frontal as FR
from gpvecchia_torch.linalg import multifrontal as MF
from gpvecchia_torch.plan import get_mf_plan, get_plan

GRAD_REL = 1e-9


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)
    monkeypatch.setattr(pe, "INTERPRET", True)
    monkeypatch.setattr(pf, "INTERPRET", True)
    monkeypatch.setattr(PL, "INTERPRET", True)
    monkeypatch.setattr(PL, "_MAX_GB", 2)
    for f in (PL._make_fused, PL._make_leaf, PL._make_afront,
              pc._make_fused_solver, pc._make_solver):
        f.cache_clear()
    yield
    for f in (PL._make_fused, PL._make_leaf, PL._make_afront,
              pc._make_fused_solver, pc._make_solver):
        f.cache_clear()


def _t(a, dt=torch.float64):
    a = np.asarray(a)
    return torch.as_tensor(a, dtype=dt if a.dtype.kind == "f" else None)


def _np(t):
    return t.detach().numpy()


# ----------------------------------------------------- (a) the slice ----

def _grads(locs, z, covparms, nug, m, cond):
    """(port, jax) gradients of the log-likelihood in (covparms, nuggets)."""
    nug = np.asarray(nug, np.float64)
    nug_b = np.broadcast_to(nug, (len(z),))
    spec_t = zero_nugget_variant(
        GT.vecchia_specify(locs, m=m, cond_yz=cond), nug_b)
    spec_j = jax_zero_variant(GJ.vecchia_specify(locs, m=m, cond_yz=cond),
                              nug_b)
    fj = GJ.loglik_fn(spec_j)
    zj = jnp.asarray(z)
    gj = jax.grad(lambda c, g: fj(zj, c, g), argnums=(0, 1))(
        jnp.asarray(covparms, jnp.float64), jnp.asarray(nug))
    c = torch.tensor(covparms, dtype=torch.float64, requires_grad=True)
    g = torch.tensor(nug, dtype=torch.float64, requires_grad=True)
    ll = GT.loglik_fn(spec_t, device="cpu")(torch.as_tensor(z), c, g)
    gt = torch.autograd.grad(ll, (c, g))
    return [_np(a) for a in gt], [np.asarray(a) for a in gj]


def _assert_grads_match(ours, ref):
    scale = max(np.abs(r).max() for r in ref)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_REL * scale)


def _data(n=120, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, 2)), rng.normal(size=n)


@pytest.mark.parametrize("cond", ["y", "z", "SGV", "SGVT"])
@pytest.mark.parametrize("vector", [False, True])
def test_grad_matches_jax(cond, vector):
    locs, z = _data()
    nug = np.linspace(0.1, 0.3, len(z)) if vector else 0.2
    _assert_grads_match(*_grads(locs, z, (1.0, 0.3, 0.5), nug, 8, cond))


@pytest.mark.parametrize("nu", [1.5, 2.5])
def test_grad_matches_jax_smoothness(nu):
    locs, z = _data(seed=1)
    ours, ref = _grads(locs, z, (1.3, 0.1, nu), 0.15, 8, "SGV")
    assert ours[0][2] == 0.0                      # closed form: d/dnu = 0
    _assert_grads_match(ours, ref)


def test_grad_with_na_matches_jax():
    locs, z = _data(seed=2)
    z[[3, 17, 40]] = np.nan
    nug = np.linspace(0.1, 0.3, len(z))
    ours, ref = _grads(locs, z, (1.0, 0.3, 0.5), nug, 8, "SGV")
    assert np.all(ours[1][[3, 17, 40]] == 0.0)    # inflated: no gradient
    _assert_grads_match(ours, ref)


@pytest.mark.parametrize("which", ["some", "all"])
def test_grad_zero_nuggets_matches_jax(which):
    locs, z = _data(n=80, seed=3)
    nug = np.full(len(z), 0.2)
    if which == "some":
        nug[[0, 5, 40]] = 0.0
    else:
        nug[:] = 0.0                 # no latent left, no denominator
    _assert_grads_match(*_grads(locs, z, (1.0, 0.3, 0.5), nug, 6, "SGV"))


def test_grad_runs_the_functions_backward(monkeypatch):
    """The CPU gradient goes through the autograd Functions' backward (H5's,
    H6's and H7's plain versions and the H4 pullback), not through torch
    autograd of the plain forward; and raises no warning (the smoothness
    dispatch reads covparms detached)."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(MS, "matern_solve_e0_bwd_plain")
    spy(FR, "front_factor_vjp")
    spy(FR, "extend_add_bwd_plain")
    spy(FR, "leaf_assemble_bwd_plain")
    locs, z = _data(n=600, seed=4)
    spec = GT.vecchia_specify(locs, m=8)
    assert get_mf_plan(get_plan(spec))[0].depth >= 1
    c = torch.tensor([1.0, 0.3, 0.5], dtype=torch.float64, requires_grad=True)
    g = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ll = GT.loglik_fn(spec, device="cpu")(torch.as_tensor(z), c, g)
        ll.backward()
    assert set(calls) == {"matern_solve_e0_bwd_plain", "front_factor_vjp",
                          "extend_add_bwd_plain", "leaf_assemble_bwd_plain"}
    assert torch.isfinite(c.grad).all() and torch.isfinite(g.grad)


def test_grad_keeps_input_devices_and_dtypes():
    """Each input's gradient comes back in that input's dtype, here float64
    parameters into a float32 evaluation."""
    locs, z = _data(n=100, seed=5)
    spec = GT.vecchia_specify(locs, m=6)
    c = torch.tensor([1.0, 0.3, 0.5], dtype=torch.float64, requires_grad=True)
    g = torch.full((len(z),), 0.2, dtype=torch.float64, requires_grad=True)
    ll = GT.loglik_fn(spec, device="cpu", dtype=torch.float32)(
        torch.as_tensor(z), c, g)
    assert ll.dtype == torch.float32
    dc, dg = torch.autograd.grad(ll, (c, g))
    assert dc.dtype == dg.dtype == torch.float64
    ref = GT.loglik_fn(spec, device="cpu")(torch.as_tensor(z), c, g)
    rc, rg = torch.autograd.grad(ref, (c, g))
    np.testing.assert_allclose(_np(dc), _np(rc), rtol=1e-3)
    np.testing.assert_allclose(_np(dg), _np(rg), rtol=0,
                               atol=1e-3 * np.abs(_np(rg)).max())


def test_poisoned_rows_match_jax():
    """A non-SPD conditioning matrix drops its row from the value, as in the
    JAX package.  The port's gradient is that of the value it computes: the
    dropped rows are constants, so it equals ``jax.grad`` over the other
    rows alone, and it is finite.  (The JAX package's gradient is NaN in
    (sig2, rho) and at the dropped rows' neighbors' nuggets: 0 times the
    NaN row's derivative.)"""
    locs = np.random.default_rng(11).uniform(size=(400, 2))
    plan = get_plan(GT.vecchia_specify(locs, m=12, cond_yz="SGV"))
    nug = np.full(plan.n_all, 0.15)
    nug[plan.NN[plan.nb_resp][0]] = -1e3
    W = np.random.default_rng(0).normal(size=plan.NN.shape)
    cp = np.array([1.0, 0.2, 0.5])

    def fj(c, g, rows):
        col, bad = jax_u_entries(jnp.asarray(plan.locs),
                                 jnp.asarray(plan.NN[rows]),
                                 jnp.asarray(plan.valid[rows]),
                                 jnp.asarray(plan.cond[rows]), g, jax_matern,
                                 c)
        return jnp.sum(jnp.where(bad[:, None], 0.0, col) * W[rows]), bad

    _, bad_j = fj(jnp.asarray(cp), jnp.asarray(nug), slice(None))
    good = ~np.asarray(bad_j)
    nan_ref = [np.asarray(a) for a in jax.grad(
        lambda c, g: fj(c, g, slice(None))[0], argnums=(0, 1))(
            jnp.asarray(cp), jnp.asarray(nug))]
    ref = [np.asarray(a) for a in jax.grad(
        lambda c, g: fj(c, g, good)[0], argnums=(0, 1))(
            jnp.asarray(cp), jnp.asarray(nug))]
    c = torch.tensor(cp, requires_grad=True)
    g = torch.tensor(nug, requires_grad=True)
    col, bad = u_entries(_t(plan.locs), _t(plan.NN), _t(plan.valid),
                         _t(plan.cond), g, c)
    np.testing.assert_array_equal(bad.numpy(), ~good)
    assert bad.any() and np.isnan(nan_ref[0]).any()
    (torch.where(bad[:, None], 0.0, col) * _t(W)).sum().backward()
    ours = [_np(c.grad), _np(g.grad)]
    scale = max(np.abs(r).max() for r in ref)
    for a, b, n in zip(ours, ref, nan_ref):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * scale)
        ok = ~np.isnan(n)
        np.testing.assert_allclose(a[ok], n[ok], rtol=0, atol=1e-10 * scale)


# ----------------------------------------- (b) H5 and solve_e0_bwd ----

def _h5_inputs(n=300, m=8, seed=5, dt=torch.float32):
    locs = np.random.default_rng(seed).uniform(size=(n, 2))
    plan = get_plan(GT.vecchia_specify(locs, m=m, cond_yz="SGV"))
    nug = np.random.default_rng(seed + 1).uniform(0.1, 0.2, plan.n_all)
    resp = plan.valid & ~plan.cond
    return plan, nug, resp, (_t(plan.locs, dt), _t(plan.NN), _t(plan.valid),
                             _t(resp), _t(nug, dt))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_h5_plain_matches_fused_solver_vjp(interpret, nu):
    """f32, n=300, F=9: H5's plain version (dcovparms, per-slot nugget
    cotangents) vs ``jax.vjp`` of ``fused_matern_solve`` with K2 in
    interpret mode.  Both are f32 refactorizations of the same matrices in
    other orders; allow 1e-3 of the largest entry (the short range keeps
    the matrices well conditioned for f32, as test_torch_u_entries does)."""
    plan, nug, resp, args = _h5_inputs()
    F, d = plan.NN.shape[1], plan.locs.shape[1]
    cp = np.array([1.0, 0.05, nu], np.float32)
    x = MS.matern_solve_e0_plain(*args, _t(cp, torch.float32))
    xbar = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    dpar, dslot = MS.matern_solve_e0_bwd_plain(*args, _t(cp, torch.float32),
                                               x, _t(xbar, torch.float32))
    pts = plan.locs[plan.NN].astype(np.float32)
    geoT = np.transpose(pts, (2, 1, 0)).reshape(d * F, -1)
    nugT = np.where(resp, nug[plan.NN], 0.0).T.astype(np.float32)
    validT = plan.valid.T.astype(np.float32)

    def f(c, ng):
        return pc.fused_matern_solve(c, ng, jnp.asarray(geoT),
                                     jnp.asarray(validT),
                                     jnp.asarray(pts.reshape(len(pts), -1)),
                                     F, d, False)

    xj, vjp = jax.vjp(f, jnp.asarray(cp), jnp.asarray(nugT))
    dcj, dnj = vjp(jnp.asarray(xbar.T))
    dcj = np.asarray(dcj)
    dslot_j = np.where(resp, np.asarray(dnj).T, 0.0)
    np.testing.assert_allclose(_np(x), np.asarray(xj).T, rtol=0,
                               atol=1e-4 * np.abs(np.asarray(xj)).max())
    dcov = _np(dpar.sum(0))
    np.testing.assert_allclose(dcov, dcj[:2], rtol=0,
                               atol=1e-3 * np.abs(dcj).max())
    assert dcj[2] == 0.0
    np.testing.assert_allclose(_np(dslot), dslot_j, rtol=0,
                               atol=1e-3 * np.abs(dslot_j).max())


def test_solve_e0_bwd_plain_matches_pallas_k2(interpret):
    """K2 one to one, f32, F=12: the packed cotangent vs
    ``_solve_e0_bwd_impl`` in interpret mode, 1e-4 of the largest entry."""
    rng = np.random.default_rng(3)
    n, F = 200, 12
    A = rng.normal(size=(n, F, F)) / np.sqrt(F)
    C = (A @ np.swapaxes(A, 1, 2) + np.eye(F)).astype(np.float32)
    iu, ju = np.triu_indices(F)
    Cp = C[:, iu, ju]
    x = np.linalg.solve(C.astype(np.float64),
                        np.eye(F)[0][None, :, None].repeat(n, 0))[..., 0]
    x = x.astype(np.float32)
    xbar = rng.normal(size=(n, F)).astype(np.float32)
    g = MS.solve_e0_bwd(_t(Cp, torch.float32), _t(x, torch.float32),
                        _t(xbar, torch.float32))
    gj = np.asarray(pc._solve_e0_bwd_impl(jnp.asarray(Cp.T), jnp.asarray(x.T),
                                          jnp.asarray(xbar.T), F)).T
    np.testing.assert_allclose(_np(g), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())


def test_h5_wrapper_reduces_to_parameter_gradients():
    """The wrapper sums the per-point partials and scatters the per-slot
    nugget cotangents: equal to torch autograd through H1's plain version,
    returned on covparms' own dtype (here float32, with values that float32
    holds exactly)."""
    plan, nug, resp, args = _h5_inputs(n=200, m=6, dt=torch.float64)
    args = args[:4]
    ng = _t(nug).requires_grad_(True)
    cp = torch.tensor([1.0, 0.25, 1.5], dtype=torch.float64,
                      requires_grad=True)
    x = MS.matern_solve_e0_plain(*args, ng, cp)
    xbar = _t(np.random.default_rng(2).normal(size=x.shape))
    ref = torch.autograd.grad((x * xbar).sum(), (cp, ng))
    dcov, dnug = MS.matern_solve_e0_bwd(*args, ng.detach(),
                                        cp.detach().float(), x.detach(), xbar)
    assert dcov.dtype == torch.float32
    np.testing.assert_allclose(_np(dcov), _np(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(_np(dnug), _np(ref[1]), rtol=0,
                               atol=1e-12 * np.abs(_np(ref[1])).max())


# ----------------------------------------------------------- (c) H6 ----

def _level_inputs(seed=0, N=2, P=9, B=6, Bc=11):
    rng = np.random.default_rng(seed)
    B1, Bc1 = B + 1, Bc + 1
    F1 = P + B1
    ch = rng.normal(size=(N, 2, Bc1, Bc1)).astype(np.float32)
    ch = ch + np.swapaxes(ch, 2, 3)
    ext = np.full((N, 2, F1), -1, np.int32)
    for n in range(N):
        for s in (0, 1):
            pos = np.sort(rng.choice(F1 - 1, size=Bc1 - 1, replace=False))
            ext[n, s, pos] = np.arange(Bc1 - 1)
            ext[n, s, F1 - 1] = Bc1 - 1
    diag = rng.uniform(1.0, 2.0, size=(N, F1)).astype(np.float32) + 4.0 * F1
    diag[:, F1 - 1] = 0.0
    rhs = rng.normal(size=(N, F1)).astype(np.float32)
    rhs[:, F1 - 1] = 0.0
    Bc1p = PL._ru(max(Bc1, PL._srows(Bc1)), 8)
    chp = np.zeros((N, 2, Bc1p, Bc1), np.float32)
    chp[:, :, :Bc1] = ch
    starts, rel, T, F1p = PL.level_kernel_plan(ext, Bc1)
    diag2 = np.zeros((N, 8, F1p), np.float32)
    diag2[:, 0, :F1] = diag
    diag2[:, 1, :F1] = rhs
    diagT = np.zeros((N, F1p, 8), np.float32)
    diagT[:, :F1, 0] = diag
    diagT[:, :F1, 1] = rhs
    return dict(ch=ch, chp=chp, ext=ext, diag=diag, rhs=rhs, starts=starts,
                rel=rel, T=T, diag2=diag2, diagT=diagT, P=P, B1=B1, Bc1=Bc1,
                F1=F1)


def _sym(a):
    return 0.5 * (a + np.swapaxes(a, -1, -2))


def _close(a, b, rel=1e-4):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1.0))


def test_h6_plain_matches_pallas_k8b(interpret):
    """K8b exactly: dupd[n, s] = G^T dfront G for any (not only symmetric)
    dfront; a gather, so f32 agrees to rounding of the one-hot matmuls."""
    rng = np.random.default_rng(4)
    N, F, Bc = 4, 30, 17
    dfront = rng.normal(size=(N, F, F)).astype(np.float32)
    ext = np.full((N, 2, F), -1, np.int32)
    for n in range(N):
        for s in range(2):
            k = int(rng.integers(5, Bc))
            pos = rng.choice(F, size=k, replace=False)
            ext[n, s, pos] = rng.choice(Bc, size=k, replace=False)
    ref = np.asarray(pe._eadd_bwd_impl(jnp.asarray(dfront), jnp.asarray(ext),
                                       Bc))
    dupd, _, _ = FR.extend_add_bwd_plain(_t(dfront, torch.float32), _t(ext),
                                         Bc)
    _close(_np(dupd), ref, 1e-6)


def test_h6_and_pullback_match_fused_level_vjp(interpret):
    """The level VJP: front_factor_vjp then H6 (dch) and the diag/rhs
    cotangents vs ``jax.vjp`` of ``fused_level``; f32, 1e-3 of scale (two
    triangular solves and a Cholesky pullback in f32)."""
    L = _level_inputs()
    P, B1, Bc1, F1 = L["P"], L["B1"], L["Bc1"], L["F1"]
    N = L["ch"].shape[0]
    rng = np.random.default_rng(7)
    dL_pp = np.tril(rng.normal(size=(N, P, P))).astype(np.float32)
    dL_bp = rng.normal(size=(N, B1, P)).astype(np.float32)
    dupd = _sym(rng.normal(size=(N, B1, B1))).astype(np.float32)
    B1p = PL._ru(B1, 8)
    dupd_p = np.zeros((N, B1p, B1), np.float32)
    dupd_p[:, :B1] = dupd

    def f(chp, diag2):
        return PL.fused_level(chp, jnp.asarray(L["starts"]),
                              jnp.asarray(L["rel"]), diag2, P, B1, Bc1, F1,
                              L["T"])

    _, vjp = jax.vjp(f, jnp.asarray(L["chp"]), jnp.asarray(L["diag2"]))
    dch_j, ddiag2_j = vjp((jnp.asarray(dL_pp), jnp.asarray(dL_bp),
                           jnp.asarray(dupd_p)))
    front = FR.extend_add_plain(_t(L["ch"], torch.float32), _t(L["ext"]),
                                _t(L["diag"], torch.float32),
                                _t(L["rhs"], torch.float32))
    FR.front_factor_plain(front, P)
    dfront = FR.front_factor_vjp(front, P, _t(dL_pp, torch.float32),
                                 _t(dL_bp, torch.float32),
                                 _t(dupd, torch.float32))
    out = torch.zeros(N, 2, Bc1, Bc1, dtype=torch.float32)
    ddv, drv = FR.extend_add_bwd(dfront, _t(L["ext"]), out)
    _close(_sym(_np(out)), _sym(np.asarray(dch_j)[:, :, :Bc1]), 1e-3)
    _close(_np(ddv), np.asarray(ddiag2_j)[:, 0, :F1], 1e-3)
    _close(_np(drv), np.asarray(ddiag2_j)[:, 1, :F1], 1e-3)


def test_h6_matches_assemble_fronts_vjp(interpret):
    """The assembly VJP: dch and the diag/rhs cotangents for a given front
    cotangent (symmetrized, as that VJP does first)."""
    L = _level_inputs(seed=13, N=2, P=20, B=30, Bc=40)
    F1, Bc1 = L["F1"], L["Bc1"]
    N = L["ch"].shape[0]
    F1p = L["diag2"].shape[-1]
    dfront = np.random.default_rng(2).normal(size=(N, F1p, F1p)).astype(
        np.float32)

    def f(chp, diag2, diagT):
        return PL.assemble_fronts(chp, jnp.asarray(L["starts"]),
                                  jnp.asarray(L["rel"]), diag2, diagT, Bc1,
                                  F1, L["T"])

    _, vjp = jax.vjp(f, jnp.asarray(L["chp"]), jnp.asarray(L["diag2"]),
                     jnp.asarray(L["diagT"]))
    dch_j, dd2_j, ddT_j = (np.asarray(a) for a in vjp(jnp.asarray(dfront)))
    out = torch.zeros(N, 2, Bc1, Bc1, dtype=torch.float32)
    ddv, drv = FR.extend_add_bwd(_t(_sym(dfront[:, :F1, :F1]),
                                    torch.float32), _t(L["ext"]), out)
    _close(_np(out), dch_j[:, :, :Bc1], 1e-6)
    _close(_np(ddv), ddT_j[:, :F1, 0], 1e-6)
    _close(_np(drv), dd2_j[:, 1, :F1] + ddT_j[:, :F1, 1], 1e-6)


def test_h6_writes_into_strided_child_blocks():
    """H6 adds into the children's [P_c:, P_c:] blocks in place."""
    L = _level_inputs(seed=2, N=3)
    Bc1 = L["Bc1"]
    dfront = _t(_sym(np.random.default_rng(1).normal(
        size=(3, L["F1"], L["F1"]))), torch.float32)
    Pc = 5
    child = torch.ones(6, Pc + Bc1, Pc + Bc1, dtype=torch.float32)
    view = child[:, Pc:, Pc:].unflatten(0, (3, 2))
    assert not view.is_contiguous()
    FR.extend_add_bwd(dfront, _t(L["ext"]), view)
    dupd, _, _ = FR.extend_add_bwd_plain(dfront, _t(L["ext"]), Bc1)
    torch.testing.assert_close(view, dupd + 1.0, rtol=0, atol=0)
    assert torch.all(child[:, :Pc] == 1.0) and torch.all(child[:, :, :Pc] == 1.0)


# ----------------------------------------------------------- (d) H7 ----

def test_h7_and_pullback_match_fused_leaf_vjp(interpret):
    """The leaf VJP: front_factor_vjp then H7 (du, d rhs_elem) and the
    diag/rhs cotangents vs ``jax.vjp`` of ``fused_leaf``; f32, 1e-3."""
    rng = np.random.default_rng(1)
    N, P, B, EL, K = 2, 11, 7, 15, 5
    B1 = B + 1
    F1 = P + B1
    ELp = PL._ru(EL, 8)
    u = np.zeros((N, ELp, K), np.float32)
    epos = np.full((N, ELp, K), -1, np.int32)
    re = np.zeros((N, ELp), np.float32)
    for n in range(N):
        for e in range(EL):
            k = rng.integers(1, K + 1)
            epos[n, e, :k] = np.sort(rng.choice(F1 - 1, size=k, replace=False))
            u[n, e, :k] = rng.normal(size=k)
            re[n, e] = rng.normal()
    diag = rng.uniform(1.0, 2.0, size=(N, F1)).astype(np.float32) + 2.0 * F1
    diag[:, F1 - 1] = 0.0
    rhs = rng.normal(size=(N, F1)).astype(np.float32)
    rhs[:, F1 - 1] = 0.0
    u_aug = np.concatenate([u, re[..., None]], axis=2)
    epos_aug = np.concatenate(
        [epos, np.where(np.arange(ELp) < EL, F1 - 1, -1)[None, :, None]
         .repeat(N, 0).astype(np.int32)], axis=2)
    F1p = PL._ru(F1, PL._TE)
    diag2 = np.zeros((N, 8, F1p), np.float32)
    diag2[:, 0, :F1] = diag
    diag2[:, 1, :F1] = rhs
    dL_pp = np.tril(rng.normal(size=(N, P, P))).astype(np.float32)
    dL_bp = rng.normal(size=(N, B1, P)).astype(np.float32)
    dupd = _sym(rng.normal(size=(N, B1, B1))).astype(np.float32)
    dupd_p = np.zeros((N, PL._ru(B1, 8), B1), np.float32)
    dupd_p[:, :B1] = dupd

    def f(uT, d2):
        return PL.fused_leaf(uT, jnp.asarray(np.swapaxes(epos_aug, 1, 2)), d2,
                             P, B1, F1)

    _, vjp = jax.vjp(f, jnp.asarray(np.swapaxes(u_aug, 1, 2)),
                     jnp.asarray(diag2))
    du_j, dd2_j = (np.asarray(a) for a in vjp(
        (jnp.asarray(dL_pp), jnp.asarray(dL_bp), jnp.asarray(dupd_p))))
    du_j = np.swapaxes(du_j, 1, 2)                    # (N, ELp, K+1)
    f32 = torch.float32
    front = FR.leaf_assemble_plain(_t(u, f32), _t(epos), _t(re, f32),
                                   _t(diag, f32), _t(rhs, f32))
    FR.front_factor_plain(front, P)
    dfront = FR.front_factor_vjp(front, P, _t(dL_pp, f32), _t(dL_bp, f32),
                                 _t(dupd, f32))
    du, dre, ddv, drv = FR.leaf_assemble_bwd(dfront, _t(u, f32), _t(epos),
                                             _t(re, f32))
    real = (np.arange(ELp) < EL)[None, :]
    _close(_np(du), du_j[..., :K], 1e-3)
    _close(np.where(real, _np(dre), 0.0), np.where(real, du_j[..., K], 0.0),
           1e-3)
    _close(_np(ddv), dd2_j[:, 0, :F1], 1e-3)
    _close(_np(drv), dd2_j[:, 1, :F1], 1e-3)


# ------------------------------------------------ (e) H4's pullback ----

@pytest.mark.parametrize("F,P", [(12, 5), (20, 20), (37, 16)])
def test_front_factor_vjp_matches_factor_fronts(interpret, F, P):
    """``front_factor_vjp`` vs ``jax.vjp`` of ``factor_fronts`` (K7's
    closed-form XLA VJP), compared symmetrized; f32, 1e-3 of scale.  The
    port's pullback reads L_pp through tril, so garbage in the factored
    front's upper triangle must not reach it."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, F, F)).astype(np.float32) * 0.1
    front = (A @ np.swapaxes(A, 1, 2) + np.eye(F, dtype=np.float32) * 3)
    dL_pp = np.tril(rng.normal(size=(3, P, P))).astype(np.float32)
    dL_bp = rng.normal(size=(3, F - P, P)).astype(np.float32)
    _, vjp = jax.vjp(lambda fr: pf.factor_fronts(fr, P), jnp.asarray(front))
    (ref,) = vjp((jnp.asarray(dL_pp), jnp.asarray(dL_bp)))
    fr = FR.front_factor_plain(_t(front, torch.float32), P)
    iu = torch.triu_indices(P, P, 1)
    fr[:, iu[0], iu[1]] = torch.nan                 # the kernel's garbage
    ours = FR.front_factor_vjp(fr, P, _t(dL_pp, torch.float32),
                               _t(dL_bp, torch.float32))
    _close(_np(ours)[:, :, :P], _sym(np.asarray(ref))[:, :, :P], 1e-3)
    assert torch.all(ours[:, P:, P:] == 0.0)


# ------------------------------------------- (e2) H9 front_factor_bwd ----

H9_REL = 1e-12

# (N, F1, P): P = 1, P below and not a multiple of 32, one past 32, B1 = 1
# (P = F1 - 1, the root's shape), P one past H9's column block of 64
H9_SHAPES = [(2, 12, 1), (2, 20, 7), (2, 70, 33), (2, 40, 39), (1, 80, 79),
             (3, 72, 65)]


def _h9_case(N, F1, P, seed):
    """float64 SPD fronts, Schur cotangents and seeds (g_logdet, g_quad)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, F1, F1)) / np.sqrt(F1)
    front = A @ np.swapaxes(A, 1, 2) + np.eye(F1)
    dupd = _sym(rng.normal(size=(N, F1 - P, F1 - P)))
    return front, dupd, 0.7, -1.3


def _exact_factor(front, P):
    """(L_pp, L_bp, upd) of fronts by XLA's float64 Cholesky."""
    L_pp = jnp.linalg.cholesky(front[:, :P, :P])
    L_bp = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
        L_pp, jnp.swapaxes(front[:, P:, :P], 1, 2), lower=True), 1, 2)
    return L_pp, L_bp, front[:, P:, P:] - L_bp @ jnp.swapaxes(L_bp, 1, 2)


@pytest.fixture
def exact_forward(monkeypatch):
    """The Pallas forwards of K7 and K4/K5 replaced by XLA's float64
    factor of the same fronts: their VJPs (the JAX package's closed-form
    pullbacks, unchanged) then get exact residuals.  The interpret-mode
    kernels' float64 factor is off by ~1e-7 relative, which would hide the
    1e-12 this comparison holds the pullback to."""
    def factor_impl(front, P):
        return _exact_factor(front, P)[:2]

    def level_impl(ch, starts, rel, diag2, P, B1, Bc1, F1, T):
        ext = PL._ext_from_plan(starts, rel, T, F1).at[:, :, F1 - 1].set(
            Bc1 - 1)
        N = ch.shape[0]
        ar = jnp.arange(N)[:, None, None]
        front = jnp.zeros((N, F1, F1), ch.dtype)
        for s in (0, 1):
            g = ext[:, s]
            ok = (g >= 0)[:, :, None] & (g >= 0)[:, None, :]
            gc = jnp.clip(g, 0)
            front += jnp.where(ok, ch[:, s][ar, gc[:, :, None],
                                              gc[:, None, :]], 0.0)
        return _pad_upd(_exact_factor(_diag_rhs(front, diag2, F1), P), B1)

    def leaf_impl(u, epos, diag2, P, B1, F1):
        lane = jnp.arange(F1)
        ua = jnp.sum(jnp.where(lane[None, None, None, :]
                               == epos[:, :, :, None], u[..., None], 0.0),
                     axis=1)                                 # (N, ELp, F1)
        front = jnp.einsum("nef,neg->nfg", ua, ua)
        return _pad_upd(_exact_factor(_diag_rhs(front, diag2, F1), P), B1)

    monkeypatch.setattr(pf, "_factor_impl", factor_impl)
    monkeypatch.setattr(PL, "_level_impl", level_impl)
    monkeypatch.setattr(PL, "_leaf_impl", leaf_impl)
    for f in (pf._make_factor, PL._make_fused, PL._make_leaf):
        f.cache_clear()
    yield
    for f in (pf._make_factor, PL._make_fused, PL._make_leaf):
        f.cache_clear()


def _diag_rhs(front, diag2, F1):
    front = front + jax.vmap(jnp.diag)(diag2[:, 0, :F1])
    front = front.at[:, F1 - 1, :].add(diag2[:, 1, :F1])
    return front.at[:, :, F1 - 1].add(diag2[:, 1, :F1])


def _pad_upd(parts, B1):
    L_pp, L_bp, upd = parts
    B1p = PL._ru(B1, 8)
    return L_pp, L_bp, jnp.pad(upd, ((0, 0), (0, B1p - B1), (0, 0)))


def _h9_jax_ref(front, dupd, gl, gq, P):
    """The symmetric front cotangent from ``jax.vjp`` of ``factor_fronts``
    (K7's custom VJP) with the Schur product, seeded as the likelihood
    seeds it: dL_pp = diag(2 g_logdet / L_ii), dL_bp[B1-1] = 2 g_quad y."""
    def f(fr):
        L_pp, L_bp = pf.factor_fronts(fr, P)
        return L_pp, L_bp, fr[:, P:, P:] - L_bp @ jnp.swapaxes(L_bp, 1, 2)

    (L_pp, L_bp, _), vjp = jax.vjp(f, jnp.asarray(front))
    dL_pp, dL_bp = _h9_seeds(L_pp, L_bp, gl, gq)
    (ref,) = vjp((jnp.asarray(dL_pp), jnp.asarray(dL_bp), jnp.asarray(dupd)))
    return _sym(np.asarray(ref))


def _h9_seeds(L_pp, L_bp, gl, gq):
    """(dL_pp, dL_bp) of logdet = 2 sum log diag L_pp and quad = |y|^2."""
    L_pp, L_bp = np.asarray(L_pp), np.asarray(L_bp)
    N, P, _ = L_pp.shape
    dL_pp = np.zeros_like(L_pp)
    dL_pp[:, np.arange(P), np.arange(P)] = 2.0 * gl / np.diagonal(
        L_pp, axis1=1, axis2=2)
    dL_bp = np.zeros_like(L_bp)
    dL_bp[:, -1] = 2.0 * gq * L_bp[:, -1]
    return dL_pp, dL_bp


def _factored_with_dupd(front, dupd, P, upper=None):
    """``front_factor_plain`` of the fronts with the Schur cotangent's lower
    triangle in [P:, P:], as H6 leaves it; ``upper`` fills the strict upper
    triangle (the kernels' unspecified values)."""
    fr = FR.front_factor_plain(_t(front), P)
    fr[:, P:, P:] = torch.tril(_t(dupd))
    if upper is not None:
        F1 = fr.shape[-1]
        fr = fr.masked_fill(torch.ones(F1, F1, dtype=torch.bool).triu(1),
                            upper)
    return fr


def _close_rel(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("N,F1,P", H9_SHAPES)
def test_h9_plain_matches_factor_fronts_vjp(exact_forward, N, F1, P):
    """``front_factor_bwd`` (its plain version here) leaves in the lower
    triangle the JAX package's symmetric cotangent, to 1e-12 in float64;
    NaN in the strict upper triangle of its input does not reach it."""
    front, dupd, gl, gq = _h9_case(N, F1, P, seed=F1 + P)
    ref = _h9_jax_ref(front, dupd, gl, gq, P)
    got = FR.front_factor_bwd(_factored_with_dupd(front, dupd, P,
                                                  upper=torch.nan),
                              P, _t(gl), _t(gq))
    got = torch.tril(got).numpy()
    assert np.isfinite(got).all()
    _close_rel(got, np.tril(ref), H9_REL)


def test_h9_with_p_zero_leaves_the_schur_cotangent():
    """P = 0 (no pivot): the front's cotangent is its Schur block's."""
    front, dupd, gl, gq = _h9_case(2, 9, 0, seed=1)
    fr = _factored_with_dupd(front, dupd, 0)
    want = fr.clone()
    FR.front_factor_bwd(fr, 0, _t(gl), _t(gq))
    torch.testing.assert_close(fr, want, rtol=0, atol=0)


def _h9_emulate(front, P, gl, gq, W):
    """H9's schedule in torch, step for step as csrc/frontal.cu runs it on
    one front batch, in place: the accumulating cotangent Abar of the
    first P columns lives transposed in the upper triangle (G[c, r] =
    Abar[r, c], r > c; its diagonal in ``gd``), column blocks of W from the
    last; the final cotangent of a finished block goes to the lower
    triangle, where L is no longer read."""
    N, F1, _ = front.shape
    A = front
    gd = 2.0 * gl / torch.diagonal(A, 0, 1, 2)[:, :P]            # seed
    for c in range(P):
        A[:, c, c + 1:] = 0.0
    A[:, :P, F1 - 1] = 2.0 * gq * A[:, F1 - 1, :P]
    A[:, :P, P:] += -2.0 * A[:, P:, :P].mT @ FR._sym_lower(A[:, P:, P:])
    for j in reversed(range(0, P, W)):
        k = min(P, j + W)
        D = torch.tril(A[:, j:k, j:k])
        # Xbar = Cbar D^{-1}, one row of Cbar a thread
        A[:, j:k, k:] = torch.linalg.solve_triangular(
            D, A[:, j:k, k:].mT, upper=False, left=False).mT
        S = A[:, j:k, k:] @ A[:, k:, j:k]                      # Xbar^T C
        Dbar = (torch.tril(A[:, j:k, j:k].mT, -1)
                + torch.diag_embed(gd[:, j:k]) - torch.tril(S))
        A[:, j:k, j:k] = _diag_block_rev(D, Dbar)
        if j > 0:
            A[:, :j, j:k] -= (A[:, j:k, j:] @ A[:, j:, :j]).mT     # Rbar
            A[:, :j, k:] -= A[:, j:k, :j].mT @ A[:, j:k, k:]       # Bbar
        A[:, k:, j:k] = 0.5 * A[:, j:k, k:].mT                 # finalize
        A[:, j:k, j:k] = 0.5 * A[:, j:k, j:k]
    return A


def _diag_block_rev(D, Dbar):
    """The diagonal block's kernel: Esym = Ebar + Ebar^T of D = chol(E)
    given Dbar (both lower) in closed form, D^{-T} (Phi + Phi^T) D^{-1}
    with Phi = tril(D^T Dbar), its diagonal halved."""
    M = torch.tril(D.mT @ Dbar)
    Phi = M - 0.5 * torch.diag_embed(torch.diagonal(M, 0, 1, 2))
    X = torch.linalg.solve_triangular(D.mT, Phi + Phi.mT, upper=True)
    E = torch.linalg.solve_triangular(D, X, upper=False, left=False)
    return 0.5 * (E + E.mT)


def _h9_emulate_two_level(front, P, gl, gq, W, OW):
    """H9's two-level schedule in torch, step for step as csrc/frontal.cu
    runs it, in place: the Schur product's reverse written into the upper
    triangle's [:P, P:] and the seed; outer panels [J, K) of OW columns from the last and
    in each, column blocks of W from the last (T = Cbar^T C, the diagonal
    block's reverse through D's inverse, the panel solve as a product, Rbar
    and Bbar on the panel's own rows); then the panel's contributions to
    the rows c < J as two products, reading the panel's rows of the upper
    triangle as one symmetric operand, and the panel's cotangent into the
    lower triangle."""
    N, F1, _ = front.shape
    A = front
    A[:, :P, P:] = -2.0 * A[:, P:, :P].mT @ FR._sym_lower(A[:, P:, P:])
    gd = 2.0 * gl / torch.diagonal(A, 0, 1, 2)[:, :P]            # seed
    for c in range(P):
        A[:, c, c + 1:P] = 0.0
    A[:, :P, F1 - 1] += 2.0 * gq * A[:, F1 - 1, :P]
    eye = torch.eye(W, dtype=A.dtype)
    for J in reversed(range(0, P, OW)):
        K = min(P, J + OW)
        for j in reversed(range(J, K, W)):
            k = min(K, j + W)
            D = torch.tril(A[:, j:k, j:k])
            Dinv = torch.linalg.solve_triangular(D, eye[:k - j, :k - j],
                                                 upper=False)
            T = A[:, j:k, k:] @ A[:, k:, j:k]                  # Cbar^T C
            Dbar = (torch.tril(A[:, j:k, j:k].mT, -1)
                    + torch.diag_embed(gd[:, j:k]) - torch.tril(Dinv.mT @ T))
            A[:, j:k, j:k] = _diag_block_rev_inv(D, Dinv, Dbar)
            A[:, j:k, k:] = Dinv.mT @ A[:, j:k, k:]              # Xbar^T
            if j > J:
                A[:, J:j, j:k] -= (A[:, j:k, j:] @ A[:, j:, J:j]).mT
                A[:, J:j, k:] -= A[:, j:k, J:j].mT @ A[:, j:k, k:]
        if J > 0:
            U = torch.triu(A[:, J:K, J:K])
            Wm = torch.cat([U + torch.triu(U, 1).mT, A[:, J:K, K:]], dim=2)
            A[:, :J, J:K] -= (Wm @ A[:, J:, :J]).mT
            A[:, :J, K:] -= A[:, J:K, :J].mT @ A[:, J:K, K:]
        for c in range(J, K):                                    # finalize
            A[:, c:, c] = 0.5 * A[:, c, c:]
    return A


def _diag_block_rev_inv(D, Dinv, Dbar):
    """``_diag_block_rev`` as the kernel computes it, by products with D's
    inverse: Esym = Dinv^T Sym Dinv, Sym = Phi + Phi^T."""
    M = torch.tril(D.mT @ Dbar)
    Phi = M - 0.5 * torch.diag_embed(torch.diagonal(M, 0, 1, 2))
    E = ((Phi + Phi.mT) @ Dinv).mT @ Dinv
    return 0.5 * (E + E.mT)


# (N, F1, P) one past the outer panels the two-level emulation runs
H9_OW_SHAPES = [(2, 30, 17), (2, 40, 25), (1, 140, 129)]
_H9_REFS = {}


@pytest.mark.parametrize("W,OW", [(8, 16), (8, 24), (FR.H9_BW, FR.H9_OW)])
@pytest.mark.parametrize("N,F1,P", H9_SHAPES + H9_OW_SHAPES)
def test_h9_two_level_order_matches_factor_fronts_vjp(exact_forward, N, F1,
                                                      P, W, OW):
    """The kernel's two-level reverse sweep (inner blocks on the panel's
    own rows, the panel's products on the rows left of it, D's inverse in
    the diagonal block and the panel solve), emulated in torch, equals the
    JAX package's cotangent to 1e-12 in float64, reading lower triangles
    only (the input's strict upper triangle is NaN)."""
    front, dupd, gl, gq = _h9_case(N, F1, P, seed=F1 + P)
    if (N, F1, P) not in _H9_REFS:
        _H9_REFS[N, F1, P] = _h9_jax_ref(front, dupd, gl, gq, P)
    ref = _H9_REFS[N, F1, P]
    got = _h9_emulate_two_level(
        _factored_with_dupd(front, dupd, P, upper=torch.nan), P, gl, gq, W,
        OW)
    got = torch.tril(got).numpy()
    assert np.isfinite(got).all()
    _close_rel(got, np.tril(ref), H9_REL)


@pytest.mark.parametrize("W", [8, FR.H9_BW])
@pytest.mark.parametrize("N,F1,P", H9_SHAPES)
def test_h9_block_order_matches_factor_fronts_vjp(exact_forward, N, F1, P,
                                                  W):
    """The kernel's blocked reverse sweep (Murray's left-looking blocked
    algorithm, in place), emulated in torch, equals the JAX package's
    cotangent to 1e-12 in float64, reading lower triangles only (the
    input's strict upper triangle is NaN)."""
    front, dupd, gl, gq = _h9_case(N, F1, P, seed=F1 + P)
    ref = _h9_jax_ref(front, dupd, gl, gq, P)
    got = _h9_emulate(_factored_with_dupd(front, dupd, P, upper=torch.nan),
                      P, gl, gq, W)
    got = torch.tril(got).numpy()
    assert np.isfinite(got).all()
    _close_rel(got, np.tril(ref), H9_REL)


def test_h9_h6_match_fused_level_vjp(exact_forward):
    """A level's backward as ``_backward`` runs it: H9 in place, then H6
    from the front's lower triangle (its strict upper triangle NaN) into
    the children's blocks, vs ``jax.vjp`` of ``fused_level`` in float64
    with the likelihood's seeds; to 1e-12 of scale."""
    L = _level_inputs(seed=5, N=2, P=13, B=8, Bc=14)
    P, B1, Bc1, F1 = L["P"], L["B1"], L["Bc1"], L["F1"]
    N = L["ch"].shape[0]
    f64 = np.float64
    dupd = _sym(np.random.default_rng(8).normal(size=(N, B1, B1)))
    gl, gq = 0.6, -0.9
    B1p = PL._ru(B1, 8)
    dupd_p = np.zeros((N, B1p, B1))
    dupd_p[:, :B1] = dupd

    def f(chp, diag2):
        return PL.fused_level(chp, jnp.asarray(L["starts"]),
                              jnp.asarray(L["rel"]), diag2, P, B1, Bc1, F1,
                              L["T"])

    (L_pp, L_bp, _), vjp = jax.vjp(f, jnp.asarray(L["chp"], f64),
                                   jnp.asarray(L["diag2"], f64))
    dL_pp, dL_bp = _h9_seeds(L_pp, L_bp, gl, gq)
    dch_j, ddiag2_j = (np.asarray(a) for a in vjp(
        (jnp.asarray(dL_pp), jnp.asarray(dL_bp), jnp.asarray(dupd_p))))
    front = FR.extend_add_plain(_t(L["ch"]), _t(L["ext"]), _t(L["diag"]),
                                _t(L["rhs"]))
    assert front.dtype == torch.float64
    FR.front_factor_plain(front, P)
    front[:, P:, P:] = _t(dupd)
    up = torch.ones(F1, F1, dtype=torch.bool).triu(1)
    front = front.masked_fill(up, torch.nan)
    FR.front_factor_bwd(front, P, _t(gl), _t(gq))
    front = front.masked_fill(up, torch.nan)
    out = torch.zeros(N, 2, Bc1, Bc1, dtype=torch.float64)
    ddv, drv = FR.extend_add_bwd(front, _t(L["ext"]), out)
    _close_rel(_sym(_np(out)), _sym(dch_j[:, :, :Bc1]), H9_REL)
    _close_rel(_np(ddv), ddiag2_j[:, 0, :F1], H9_REL)
    _close_rel(_np(drv), ddiag2_j[:, 1, :F1], H9_REL)


def _leaf_vjp_case():
    """A leaf's backward as ``_backward`` runs it up to H7: the front after
    H9 (its strict upper triangle NaN), H7's inputs (u, epos, re), and
    ``jax.vjp`` of ``fused_leaf`` in float64 with the likelihood's seeds
    (du_j, dd2_j), the real elements' mask and (F1, K)."""
    rng = np.random.default_rng(3)
    N, P, B, EL, K = 2, 10, 6, 13, 4
    B1 = B + 1
    F1 = P + B1
    ELp = PL._ru(EL, 8)
    u = np.zeros((N, ELp, K))
    epos = np.full((N, ELp, K), -1, np.int32)
    re = np.zeros((N, ELp))
    for n in range(N):
        for e in range(EL):
            k = rng.integers(1, K + 1)
            epos[n, e, :k] = np.sort(rng.choice(F1 - 1, size=k, replace=False))
            u[n, e, :k] = rng.normal(size=k)
            re[n, e] = rng.normal()
    diag = rng.uniform(1.0, 2.0, size=(N, F1)) + 2.0 * F1
    diag[:, F1 - 1] = 0.0
    rhs = rng.normal(size=(N, F1))
    rhs[:, F1 - 1] = 0.0
    u_aug = np.concatenate([u, re[..., None]], axis=2)
    epos_aug = np.concatenate(
        [epos, np.where(np.arange(ELp) < EL, F1 - 1, -1)[None, :, None]
         .repeat(N, 0).astype(np.int32)], axis=2)
    F1p = PL._ru(F1, PL._TE)
    diag2 = np.zeros((N, 8, F1p))
    diag2[:, 0, :F1] = diag
    diag2[:, 1, :F1] = rhs
    dupd = _sym(rng.normal(size=(N, B1, B1)))
    dupd_p = np.zeros((N, PL._ru(B1, 8), B1))
    dupd_p[:, :B1] = dupd
    gl, gq = -0.4, 1.1

    def f(uT, d2):
        return PL.fused_leaf(uT, jnp.asarray(np.swapaxes(epos_aug, 1, 2)), d2,
                             P, B1, F1)

    (L_pp, L_bp, _), vjp = jax.vjp(f, jnp.asarray(np.swapaxes(u_aug, 1, 2)),
                                   jnp.asarray(diag2))
    dL_pp, dL_bp = _h9_seeds(L_pp, L_bp, gl, gq)
    du_j, dd2_j = (np.asarray(a) for a in vjp(
        (jnp.asarray(dL_pp), jnp.asarray(dL_bp), jnp.asarray(dupd_p))))
    du_j = np.swapaxes(du_j, 1, 2)
    front = FR.leaf_assemble_plain(_t(u), _t(epos), _t(re), _t(diag),
                                   _t(rhs))
    FR.front_factor_plain(front, P)
    front[:, P:, P:] = _t(dupd)
    up = torch.ones(F1, F1, dtype=torch.bool).triu(1)
    front = front.masked_fill(up, torch.nan)
    FR.front_factor_bwd(front, P, _t(gl), _t(gq))
    front = front.masked_fill(up, torch.nan)
    real = (np.arange(ELp) < EL)[None, :]
    return front, (_t(u), _t(epos), _t(re)), du_j, dd2_j, real, F1, K


def test_h9_h7_match_fused_leaf_vjp(exact_forward):
    """The leaf's backward as ``_backward`` runs it: H9 in place, then H7
    from the front's lower triangle (strict upper NaN), vs ``jax.vjp`` of
    ``fused_leaf`` in float64 with the likelihood's seeds; 1e-12."""
    front, args, du_j, dd2_j, real, F1, K = _leaf_vjp_case()
    du, dre, ddv, drv = FR.leaf_assemble_bwd(front, *args)
    _close_rel(_np(du), du_j[..., :K], H9_REL)
    _close_rel(np.where(real, _np(dre), 0.0),
               np.where(real, du_j[..., K], 0.0), H9_REL)
    _close_rel(_np(ddv), dd2_j[:, 0, :F1], H9_REL)
    _close_rel(_np(drv), dd2_j[:, 1, :F1], H9_REL)


def _band_start(b, R, F1):
    """``band_start`` of csrc/frontal.cu: the first row of band b of R."""
    need = F1 * (F1 + 1) // 2 * b
    r = int(math.sqrt(2.0 * need / R))
    while r > 0 and (r - 1) * r // 2 * R >= need:
        r -= 1
    while r * (r + 1) // 2 * R < need:
        r += 1
    return r


def _h7_emulate(dfront, u, epos, re, R):
    """H7's kernel in torch, in its order of summation: the lower triangle
    in R row bands; each slot sums, over the element's slots in order (the
    RHS weight last, at F1-1), the entries dfront[max][min] of its pairs
    whose row lies in the band, and adds twice that to its sum band by
    band.  Returns (du, d rhs_elem)."""
    N, EL, K = u.shape
    F1 = dfront.shape[-1]
    pos = torch.cat([epos.long(), torch.full((N, EL, 1), F1 - 1)], 2)
    val = torch.cat([u, re[..., None]], 2)
    out = torch.zeros_like(val)
    hi = torch.maximum(pos[..., :, None], pos[..., None, :])
    lo = torch.minimum(pos[..., :, None], pos[..., None, :])
    ok = (pos[..., :, None] >= 0) & (pos[..., None, :] >= 0)
    ar = torch.arange(N)[:, None, None, None]
    ent = dfront[ar, hi.clamp(min=0), lo.clamp(min=0)]
    for b in range(R):
        r0, r1 = _band_start(b, R, F1), _band_start(b + 1, R, F1)
        inb = ok & (hi >= r0) & (hi < r1)
        acc = torch.zeros_like(val)
        for l in range(K + 1):
            acc = acc + torch.where(inb[..., l], ent[..., l], 0.0) \
                * val[..., l, None]
        out = out + (acc + acc)
    return out[..., :K], out[..., K]


@pytest.mark.parametrize("R", [1, 2, 5])
def test_h7_band_order_matches_fused_leaf_vjp(exact_forward, R):
    """H7's order of summation over R row bands (the kernel's at the leaf
    is one band in float32, several in float64), emulated in torch from
    the front's lower triangle, equals ``jax.vjp`` of ``fused_leaf`` in
    float64 to 1e-12."""
    front, (u, epos, re), du_j, _, real, F1, K = _leaf_vjp_case()
    du, dre = _h7_emulate(torch.tril(front.nan_to_num(0.0)), u, epos, re, R)
    _close_rel(_np(du), du_j[..., :K], H9_REL)
    _close_rel(np.where(real, _np(dre), 0.0),
               np.where(real, du_j[..., K], 0.0), H9_REL)


def test_h6_h7_read_lower_triangles():
    """H6 and H7 (their CPU path) read the front cotangent through its
    lower triangle: NaN above the diagonal changes nothing."""
    L = _level_inputs(seed=3, N=3)
    F1, Bc1 = L["F1"], L["Bc1"]
    dfront = _t(_sym(np.random.default_rng(6).normal(size=(3, F1, F1))))
    dirty = dfront.masked_fill(torch.ones(F1, F1, dtype=torch.bool).triu(1),
                               torch.nan)
    outs = [torch.zeros(3, 2, Bc1, Bc1, dtype=torch.float64) for _ in (0, 1)]
    a = FR.extend_add_bwd(dfront, _t(L["ext"]), outs[0])
    b = FR.extend_add_bwd(dirty, _t(L["ext"]), outs[1])
    for x, y in zip((outs[0],) + a, (outs[1],) + b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    rng = np.random.default_rng(2)
    epos = np.stack([np.stack([np.sort(rng.choice(F1 - 1, 3, replace=False))
                               for _ in range(5)]) for _ in range(3)])
    u = rng.normal(size=epos.shape)
    re = rng.normal(size=epos.shape[:2])
    args = (_t(u), _t(epos.astype(np.int32)), _t(re))
    for x, y in zip(FR.leaf_assemble_bwd(dfront, *args),
                    FR.leaf_assemble_bwd(dirty, *args)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_h9_edge_shapes_cover_the_schedule():
    """The list the card check runs holds the edges of H9's schedule
    (column blocks of 64, outer panels of 128, product tiles of 64 and
    128): P = 0, 1, below and one past a block and a panel, P = F1 - 1,
    P not a multiple of a panel, and a front one past a tile."""
    shapes = set(FR.H9_EDGE_SHAPES)
    P_of = {P for _, _, P in shapes}
    assert {0, 1} <= P_of
    W = FR.H9_BW
    assert {W - 1, W, W + 1, 2 * W - 1, 2 * W, 2 * W + 1} <= P_of
    assert any(P == F1 - 1 for _, F1, P in shapes)
    assert any(P == F1 - 1 and P > W for _, F1, P in shapes)
    assert {129, 257} <= {F1 for _, F1, _ in shapes}
    assert all(0 <= P < F1 for _, F1, P in shapes)
    OW = FR.H9_OW
    assert OW % W == 0
    assert {OW - 1, OW, OW + 1, 2 * OW + 1, 3 * OW, 3 * OW + 1,
            OW + W} <= P_of
    assert any(P == F1 - 1 and P > 2 * OW for _, F1, P in shapes)
    assert any(P % OW and P % OW != 1 and P > OW for _, _, P in shapes)
    assert (3, 330, 105) in shapes          # the leaf: two blocks


# ------------------------------------------------- (f) gradcheck ----

def test_gradcheck_matern_solve_e0():
    plan, nug, resp, args = _h5_inputs(n=40, m=4, dt=torch.float64)
    nu = torch.tensor([1.5], dtype=torch.float64)

    def f(sr, ng):
        return MS.matern_solve_e0(*args[:4], ng, torch.cat([sr, nu]))

    sr = torch.tensor([1.1, 0.25], dtype=torch.float64, requires_grad=True)
    ng = _t(nug).requires_grad_(True)
    assert torch.autograd.gradcheck(f, (sr, ng))


@pytest.mark.parametrize("n", [20, 400])
def test_gradcheck_mf_factor(n):
    """n=20 is a single-front plan (the leaf is the root, H7 only); n=400
    has internal levels (H6)."""
    rng = np.random.default_rng(n)
    plan = get_plan(GT.vecchia_specify(rng.uniform(size=(n, 2)), m=4))
    mf, _ = get_mf_plan(plan, leaf_elems=24)
    assert (mf.depth == 0) == (n == 20)
    lr = plan.latent_rank.astype(np.int64)
    ev = np.where(plan.cond, lr[plan.NN], -1)
    u = np.where(ev >= 0, rng.normal(size=ev.shape), 0.0)
    u[:, 0] = np.abs(u[:, 0]) + 1.0
    levels = MF.mf_device_arrays(mf, "cpu")
    ins = [_t(u), _t(rng.uniform(1.0, 3.0, size=plan.n_lat)),
           _t(rng.normal(size=ev.shape[0])), _t(rng.normal(size=plan.n_lat))]
    ins = [a.requires_grad_(True) for a in ins]
    assert torch.autograd.gradcheck(
        lambda *a: MF.mf_factor(levels, *a), ins, fast_mode=True)
