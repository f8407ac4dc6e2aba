"""U entries and H1 (matern_solve_e0) vs the JAX package on the CPU.

The port's covariance closed forms and ``u_entries`` (whose CPU path is
H1's plain version) are held against ``gpvecchia_tpu`` in float64; H1's
plain version is also held against the Pallas kernel it replaces,
``pallas_crout.fused_matern_solve``, run in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpvecchia_tpu.kernels.pallas_crout as pc
from gpvecchia_tpu.kernels.covariance import matern as jax_matern
from gpvecchia_tpu.kernels.u_entries import u_entries as jax_u_entries

from gpvecchia_torch import vecchia_specify
from gpvecchia_torch.kernels import matern_solve as ms
from gpvecchia_torch.kernels.covariance import matern
from gpvecchia_torch.kernels.matern_solve import (matern_solve_e0,
                                                  matern_solve_e0_plain,
                                                  max_neighbors)
from gpvecchia_torch.kernels.u_entries import u_entries
from gpvecchia_torch.linalg.multifrontal import mf_device_arrays, mf_factor
from gpvecchia_torch.plan import get_mf_plan, get_plan
from gpvecchia_torch.utils import trace

torch.set_default_dtype(torch.float64)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_closed_forms_match_jax(nu):
    dist = np.random.default_rng(3).uniform(0.0, 2.0, size=500)
    dist[:7] = 0.0
    cp = np.array([1.3, 0.25, nu])
    ours = matern(torch.as_tensor(dist), torch.as_tensor(cp)).numpy()
    ref = np.asarray(jax_matern(jnp.asarray(dist), jnp.asarray(cp)))
    np.testing.assert_allclose(ours, ref, rtol=1e-13, atol=0)


def _spec_inputs(n=400, m=12, seed=11):
    locs = np.random.default_rng(seed).uniform(size=(n, 2))
    plan = get_plan(vecchia_specify(locs, m=m, cond_yz="SGV"))
    nug_point = np.full(plan.n_all, 0.15)
    return plan, nug_point


@pytest.mark.parametrize("poison", [False, True])
def test_u_entries_matches_jax(poison):
    plan, nug_point = _spec_inputs()
    if poison:
        # a hugely negative nugget on one response-conditioned neighbor makes
        # every conditioning matrix that holds it non-SPD
        q = plan.NN[plan.nb_resp][0]
        nug_point[q] = -1e3
    cp = np.array([1.0, 0.2, 0.5])
    col, bad = u_entries(torch.as_tensor(plan.locs),
                         torch.as_tensor(plan.NN), torch.as_tensor(plan.valid),
                         torch.as_tensor(plan.cond),
                         torch.as_tensor(nug_point), cp)
    colj, badj = jax_u_entries(jnp.asarray(plan.locs), jnp.asarray(plan.NN),
                               jnp.asarray(plan.valid),
                               jnp.asarray(plan.cond), jnp.asarray(nug_point),
                               jax_matern, jnp.asarray(cp))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(badj))
    assert bad.any() == poison
    colj = np.asarray(colj)
    np.testing.assert_allclose(col.numpy(), colj, rtol=0,
                               atol=1e-12 * np.abs(colj).max())


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_h1_plain_matches_pallas_interpret(interpret, nu):
    """f32, n=300, F=9: both sides are float32 factorizations of the same
    SPD matrices in other orders; allow 1e-4 of the largest entry.  The
    short range (0.05, about the point spacing) keeps the smooth kernels'
    conditioning matrices well conditioned enough for float32."""
    plan, nug_point = _spec_inputs(n=300, m=8, seed=5)
    F, d = plan.NN.shape[1], plan.locs.shape[1]
    cp = np.array([1.0, 0.05, nu], np.float32)
    resp = plan.valid & ~plan.cond
    x = matern_solve_e0_plain(
        torch.as_tensor(plan.locs, dtype=torch.float32),
        torch.as_tensor(plan.NN), torch.as_tensor(plan.valid),
        torch.as_tensor(resp), torch.as_tensor(nug_point, dtype=torch.float32),
        torch.as_tensor(cp)).numpy()
    pts = plan.locs[plan.NN].astype(np.float32)            # (n, F, d)
    geoT = np.transpose(pts, (2, 1, 0)).reshape(d * F, -1)
    nugT = np.where(resp, nug_point[plan.NN], 0.0).T.astype(np.float32)
    validT = plan.valid.T.astype(np.float32)
    xj = pc.fused_matern_solve(jnp.asarray(cp), jnp.asarray(nugT),
                               jnp.asarray(geoT), jnp.asarray(validT),
                               jnp.asarray(pts.reshape(len(pts), -1)),
                               F, d, False)
    xj = np.asarray(xj).T
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-4 * np.abs(xj).max())


def _launches(*kernels):
    """The launch counts of ``kernels`` in the port's trace table."""
    tab = trace.table()
    return tuple(tab.get(f"launches.{k}", {"count": 0})["count"]
                 for k in kernels)


def test_h1_wrapper_takes_plain_version_on_cpu():
    plan, nug_point = _spec_inputs(n=200, m=6)
    args = (torch.as_tensor(plan.locs), torch.as_tensor(plan.NN),
            torch.as_tensor(plan.valid),
            torch.as_tensor(plan.valid & ~plan.cond),
            torch.as_tensor(nug_point))
    before = _launches("matern_solve_e0")
    x = matern_solve_e0(*args, (1.0, 0.2, 0.5))
    assert _launches("matern_solve_e0") == before   # no kernel on the CPU
    torch.testing.assert_close(
        x, matern_solve_e0_plain(*args, torch.tensor([1.0, 0.2, 0.5])),
        rtol=0, atol=0)


def test_h1_shared_memory_bound():
    # m=40 at d=2 fits a warp's 48 KB in both precisions
    assert max_neighbors(2, torch.float64) >= 41
    assert max_neighbors(2, torch.float32) > max_neighbors(2, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_h1_h5_share_the_shared_memory_bound(dtype):
    """H1 and H5 refuse the same F, before any launch, and name the bound
    they check: a value is computed only where its gradient can be."""
    F = max_neighbors(2, dtype) + 1
    locs = torch.zeros(F, 2, dtype=dtype)
    NN = torch.arange(F, dtype=torch.int32)[None]
    valid = torch.ones(1, F, dtype=torch.bool)
    nug = torch.zeros(F, dtype=dtype)
    x = torch.zeros(1, F, dtype=dtype)
    cp = torch.tensor([1.0, 0.2, 0.5])
    bound = f"F <= {F - 1} for d=2"
    with pytest.raises(ValueError, match=bound):
        ms._launch(locs, NN, valid, valid, nug, cp)
    with pytest.raises(ValueError, match=bound):
        ms._launch_bwd(locs, NN, valid, valid, nug, cp, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("F0,F1", [(5, 8), (21, 24)])
def test_plain_versions_ignore_identity_padding(F0, F1, dtype):
    """H1 and H5 round F up to an instantiated size with invalid slots,
    which the covariance build identity-extends: C becomes [C 0; 0 I].  The
    plain versions give the unpadded x, dpar and dslot on such inputs, and
    exactly 0 in the padded slots of x and dslot.  The shared slots agree to
    a few units in the last place, not bit for bit: LAPACK's Cholesky splits
    a matrix recursively at a point that depends on its size, and torch sums
    dpar over (F, F) in a shape-dependent order.  (The kernel's padding is
    exact by construction; ``chip_smoke.py`` checks that on the card.)"""
    plan, _ = _spec_inputs(n=400, m=F0 - 1)
    n, pad = plan.NN.shape[0], F1 - F0
    resp = plan.valid & ~plan.cond

    def padded(a, fill):
        return torch.as_tensor(np.concatenate(
            [a, np.full((n, pad), fill, a.dtype)], 1))

    locs = torch.as_tensor(plan.locs, dtype=dtype)
    nug = torch.full((plan.n_all,), 0.15, dtype=dtype)
    cp = torch.tensor([1.0, 0.2, 0.5])
    small = (locs, torch.as_tensor(plan.NN), torch.as_tensor(plan.valid),
             torch.as_tensor(resp), nug, cp)
    big = (locs, padded(plan.NN, 0), padded(plan.valid, False),
           padded(resp, False), nug, cp)
    xbar = np.random.default_rng(1).normal(size=(n, F0))
    x0 = matern_solve_e0_plain(*small)
    x1 = matern_solve_e0_plain(*big)
    dpar0, dslot0 = ms.matern_solve_e0_bwd_plain(
        *small, x0, torch.as_tensor(xbar, dtype=dtype))
    dpar1, dslot1 = ms.matern_solve_e0_bwd_plain(
        *big, x1, padded(xbar, 0.0).to(dtype))
    assert x1.shape == (n, F1) and dslot1.shape == (n, F1)
    assert not x1[:, F0:].any() and not dslot1[:, F0:].any()
    eps = torch.finfo(dtype).eps
    for got, want, ulps in ((x1[:, :F0], x0, 8), (dslot1[:, :F0], dslot0, 8),
                            (dpar1, dpar0, 1024)):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=0,
            atol=ulps * eps * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_h1_h5_route_by_f_and_dtype(dtype):
    """The register route takes F up to its largest instantiated size (a
    multiple of 8, since F is padded to one), the shared-memory route the
    rest of what ``max_neighbors`` accepts; nothing else decides."""
    top = ms.REGS_MAX_F[dtype]
    assert top % 8 == 0 and top < max_neighbors(2, dtype)
    assert [ms.route(F, dtype) for F in (1, top, top + 1,
                                         max_neighbors(2, dtype))] == [
        "registers", "registers", "shared", "shared"]


def _second_order_inputs(which):
    """(function, inputs) of one of the port's autograd Functions at a tiny
    size.  The function squares the Function's outputs, so that the
    cotangent reaching its backward itself depends on the inputs."""
    plan, nug_point = _spec_inputs(n=60, m=4)
    if which == "matern_solve_e0":
        args = (torch.as_tensor(plan.locs), torch.as_tensor(plan.NN),
                torch.as_tensor(plan.valid),
                torch.as_tensor(plan.valid & ~plan.cond))
        ins = (torch.tensor([1.0, 0.2, 0.5]), torch.as_tensor(nug_point))
        return (lambda c, g: (matern_solve_e0(*args, g, c) ** 2).sum()), ins
    mf, _ = get_mf_plan(plan)
    levels = mf_device_arrays(mf, "cpu")
    rng = np.random.default_rng(0)
    E, K = plan.NN.shape
    ins = (torch.as_tensor(np.where(plan.cond, 0.1, 0.0)),
           torch.as_tensor(rng.uniform(1.0, 2.0, plan.n_lat)),
           torch.as_tensor(rng.normal(size=E)),
           torch.as_tensor(rng.normal(size=plan.n_lat)))
    return (lambda *a: sum(t ** 2 for t in mf_factor(levels, *a))), ins


@pytest.mark.parametrize("which", ["matern_solve_e0", "mf_factor"])
def test_kernel_backward_raises(which):
    """The backward of each autograd Function is itself not differentiable
    (its CUDA kernels have no backward): a second-order gradient must fail
    loudly, not silently drop the kernels' part of the graph."""
    fn, ins = _second_order_inputs(which)
    ins = [t.clone().requires_grad_(True) for t in ins]
    grads = torch.autograd.grad(fn(*ins), ins, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        sum(g.sum() for g in grads).backward()


# ------------------- the built-in Matern at a general smoothness ----
#
# H1 and H5 take every smoothness: off the closed forms each pair's log K_nu
# is evaluated in the kernel (csrc/matern_common.cuh) from the per-launch
# constants of ``general_params``.  On the CPU the plain versions run,
# through covariance.matern and bessel.log_kv_vjp.

GENERAL_NUS = [0.3, 0.8, 1.2, 2.0, 3.7]     # k = 0 ... 4, mu of both signs
GENERAL_RANGE = 0.04                       # pairs on both sides of s = 3


def _general_inputs(nu, dtype=torch.float64, n=150, m=8, seed=21):
    plan, nug_point = _spec_inputs(n=n, m=m, seed=seed)
    dist = np.linalg.norm(plan.locs[plan.NN][:, :, None]
                          - plan.locs[plan.NN][:, None, :], axis=-1)
    s = dist[plan.valid[:, :, None] & plan.valid[:, None, :]] / GENERAL_RANGE
    assert (s > 3).any() and ((s > 0) & (s <= 3)).any()
    args = (torch.as_tensor(plan.locs, dtype=dtype), torch.as_tensor(plan.NN),
            torch.as_tensor(plan.valid),
            torch.as_tensor(plan.valid & ~plan.cond),
            torch.as_tensor(nug_point, dtype=dtype))
    return plan, nug_point, args, np.array([1.3, GENERAL_RANGE, nu])


@pytest.fixture
def interpret_k3(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)
    pc._make_solver.cache_clear()
    yield
    pc._make_solver.cache_clear()


@pytest.mark.parametrize("nu", GENERAL_NUS)
def test_general_plain_matches_pallas_k3(interpret_k3, nu):
    """The general Matern's plain H1 vs the JAX package's general path, its
    packed covariance solved by K3 (``packed_solve_e0``) in interpret mode:
    1e-10 of the largest entry in float64."""
    from gpvecchia_tpu.kernels.u_entries import \
        build_cov_packed as jax_build_cov_packed
    plan, nug_point, args, cp = _general_inputs(nu)
    x = matern_solve_e0_plain(*args, torch.as_tensor(cp)).numpy()
    Cp = jax_build_cov_packed(jnp.asarray(plan.locs), jnp.asarray(plan.NN),
                              jnp.asarray(plan.valid), jnp.asarray(plan.cond),
                              jnp.asarray(nug_point), jax_matern,
                              jnp.asarray(cp))
    xj = np.asarray(pc.packed_solve_e0(Cp, plan.NN.shape[1])).T
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-10 * np.abs(xj).max())


def test_general_params_reproduce_log_kv():
    """The per-launch constants of the general kernels, run through the
    kernel's recurrences (Temme's series with the tabled reciprocals, the
    climb and its next ratio) in float64 numpy, give ``bessel.log_kv_impl``
    at nu, nu + h and |nu - h| and K_{nu+1}/K_nu on x <= 3, also at a nu
    within 1e-3 of a half-integer, where nu + h rounds to another k."""
    from gpvecchia_torch.kernels import bessel
    x = np.geomspace(1e-3, 3.0, 200)
    for nu in GENERAL_NUS + [1.4995]:
        for dtype in (torch.float64, torch.float32):
            w = ms.general_params(nu, dtype)
            h = bessel.nu_step(dtype)
            nut = torch.tensor(nu, dtype=dtype)
            orders = (nut, nut + h, torch.abs(nut - h))
            for e, order in enumerate(orders):
                c = w[e * ms.KV_WORDS:(e + 1) * ms.KV_WORDS]
                mu, _, fact, gam1, gam2, hgp, hgm, k = c[:8]
                rmm, rm, rp = c[8:].reshape(3, -1)
                d = -np.log(x / 2)
                md = mu * d
                ee = np.exp(md)
                small = np.abs(md) < 1e-3
                fact2 = np.where(small, 1.0 + md * md / 6.0,
                                 np.sinh(md) / np.where(small, 1.0, md))
                ff = fact * (gam1 * np.cosh(md) + gam2 * fact2 * d)
                p, q, cc = ee * hgp, hgm / ee, np.ones_like(x)
                ksum, ksum1 = ff, p
                for i in range(1, 41):
                    ff = (i * ff + p + q) * rmm[i - 1]
                    cc = cc * (x / 2) ** 2 / i
                    p, q = p * rm[i - 1], q * rp[i - 1]
                    ksum, ksum1 = ksum + cc * ff, ksum1 + cc * (p - i * ff)
                kmu, kmu1 = ksum, ksum1 * 2 / x
                r, lk = kmu1 / kmu, np.log(kmu1 if k > 0 else kmu)
                for j in range(1, int(k)):
                    r = 2 * (mu + j) / x + 1 / r
                    lk = lk + np.log(r)
                if k > 0:
                    r = 2 * (mu + k) / x + 1 / r
                ref = bessel.log_kv_impl(order.double(),
                                         torch.as_tensor(x)).numpy()
                np.testing.assert_allclose(lk, ref, rtol=1e-12, atol=0)
                if e == 0:
                    ref1 = bessel.log_kv_impl(order.double() + 1.0,
                                              torch.as_tensor(x)).numpy()
                    np.testing.assert_allclose(r, np.exp(ref1 - ref),
                                               rtol=1e-10)
            assert w[-4] == float(nut)
            assert w[-1] == 1.0 / (2.0 * float(torch.tensor(h, dtype=dtype)))
    # nu + h crosses the half-integer in float32 (k 1 -> 2), not in float64
    w32 = ms.general_params(1.4995, torch.float32)
    w64 = ms.general_params(1.4995, torch.float64)
    assert [w32[e * ms.KV_WORDS + 7] for e in range(3)] == [1.0, 2.0, 1.0]
    assert [w64[e * ms.KV_WORDS + 7] for e in range(3)] == [1.0, 1.0, 1.0]


def test_general_wrapper_takes_plain_version_on_cpu():
    """At a general smoothness ``matern_solve_e0`` runs its plain version
    on CPU tensors (no launch counted) and its backward gives d/dnu."""
    _, _, args, cp = _general_inputs(0.8, n=80, m=5)
    names = ("matern_solve_e0[general]", "matern_solve_e0_bwd[general]",
             "matern_solve_e0")
    before = _launches(*names)
    c = torch.tensor(cp, requires_grad=True)
    x = matern_solve_e0(*args, c)
    torch.testing.assert_close(x, matern_solve_e0_plain(*args, c.detach()),
                               rtol=0, atol=0)
    (x ** 2).sum().backward()
    assert c.grad[2] != 0
    assert _launches(*names) == before


def test_general_matern_routes_by_f():
    """The built-in Matern at a general smoothness reaches H1's plain
    version and neither ``build_cov_packed`` nor H8 up to
    ``max_neighbors``; above it (a CPU run asks the same bound) it takes
    the packed path; esqe always does."""
    from gpvecchia_torch.kernels import u_entries as UE
    from gpvecchia_torch.kernels.covariance import make_kernel_fn
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    plan, nug_point, args, cp = _general_inputs(0.8, n=80, m=5)
    geo = (torch.as_tensor(plan.locs), torch.as_tensor(plan.NN),
           torch.as_tensor(plan.valid), torch.as_tensor(plan.cond))
    nug = torch.as_tensor(nug_point)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((ms, "matern_solve_e0_plain"), (UE, "solve_e0"),
                          (UE, "build_cov_packed")):
            mp.setattr(mod, name, spy(mod, name))
        UE.u_entries(*geo, nug, torch.as_tensor(cp))
        assert calls == {"matern_solve_e0_plain": 1}
        calls.clear()
        UE.u_entries(*geo, nug, torch.tensor([0.8, 0.3, 0.4, 0.2]),
                     make_kernel_fn("esqe"))
        assert calls.get("matern_solve_e0_plain") is None
        assert calls["solve_e0"] > 0 and calls["build_cov_packed"] > 0
        calls.clear()
        mp.setattr(UE, "max_neighbors", lambda d, dtype: plan.NN.shape[1] - 1)
        col, _ = UE.u_entries(*geo, nug, torch.as_tensor(cp))
        assert calls.get("matern_solve_e0_plain") is None
        assert calls["solve_e0"] > 0 and calls["build_cov_packed"] > 0
    mp_col, _ = UE.u_entries(*geo, nug, torch.as_tensor(cp))
    torch.testing.assert_close(col, mp_col, rtol=0,
                               atol=1e-11 * mp_col.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_general_f_above_the_bound_keeps_the_packed_path(dtype):
    """An F that the fused kernels refuse is exactly one that the packed
    path still takes (H8's own bound is larger): a general smoothness at
    F = max_neighbors + 1 runs there as it always did."""
    F = max_neighbors(2, dtype) + 1
    assert F <= ms._max_f(0, dtype, ms._FWD_VECS)
