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

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
    spy(MF, "front_factor_vjp")
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
