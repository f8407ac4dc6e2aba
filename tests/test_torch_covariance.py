"""The port's covariances vs the JAX package on the CPU, in float64.

* ``log_kv`` (Temme / CF2 / log-space climb) against the JAX ``log_kv`` and
  against ``scipy.special.kve`` on a nu x x grid (nu in [0.05, 10], x in
  [1e-5, 60], both sides of the Temme/CF2 switch at x = 3), and its d/dx
  and d/dnu against ``jax.grad``;
* the general-smoothness Matern, ``esqe`` and both kinds of user callable:
  value and VJP (in dist and covparms, d/dnu included) against the JAX
  package's.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch
from scipy.special import kve

import jax
import jax.numpy as jnp

from gpvecchia_tpu.kernels import bessel as jax_bessel
from gpvecchia_tpu.kernels import covariance as jax_cov

from gpvecchia_torch.kernels import bessel, covariance

torch.set_default_dtype(torch.float64)

# log_kv vs the JAX package and vs scipy: relative to max(|log K|, 1).
# Temme's gam1 = (1/Gamma(1-mu) - 1/Gamma(1+mu)) / (2 mu) cancels for small
# mu and amplifies the last bits of lgamma, which torch and XLA compute
# with other algorithms (they differ by up to 2.6e-15 on (0.4, 1.6)); on
# this grid that puts up to 5.5e-13 between the two packages and 5.4e-13
# between the JAX package and scipy (measured), so 1e-12 for both.
LOG_KV_REL = 1e-12


def _grid():
    nu = np.geomspace(0.05, 10.0, 41)
    x = np.concatenate([np.geomspace(1e-5, 60.0, 57), [2.999, 3.0, 3.001]])
    return np.meshgrid(nu, x, indexing="ij")


def _rel(a, b):
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))


def test_log_kv_matches_jax():
    N, X = _grid()
    ours = bessel.log_kv(torch.as_tensor(N), torch.as_tensor(X)).numpy()
    ref = np.asarray(jax_bessel.log_kv(jnp.asarray(N), jnp.asarray(X)))
    assert _rel(ours, ref) <= LOG_KV_REL


def test_log_kv_matches_scipy():
    N, X = _grid()
    ours = bessel.log_kv(torch.as_tensor(N), torch.as_tensor(X)).numpy()
    assert _rel(ours, np.log(kve(N, X)) - X) <= LOG_KV_REL


@pytest.mark.parametrize("nu", [0.3, 0.8, 2.0, 7.4])
def test_log_kv_scalar_nu_matches_grid(nu):
    """A scalar smoothness (the Matern's case: branches run on subsets,
    the climb only as far as k) gives the elementwise values."""
    x = np.geomspace(1e-4, 40.0, 300)
    a = bessel.log_kv(nu, torch.as_tensor(x)).numpy()
    b = bessel.log_kv(torch.full((300,), nu), torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_series_counts_leave_values_unchanged(dtype):
    """The counts by which ``chip_smoke.py`` bounds the general Matern's
    kernels, ``_temme_kmu(terms=True)`` and ``_cf2_kmu(steps=True)``, come
    with the values returned without them: Temme's series is left after 3
    to 40 terms, no fewer at a larger x (the bound reads them on a grid
    of x), and CF2 converges within its steps."""
    for mu in (-0.5, -0.2, 0.0, 0.3, 0.5):
        m = torch.tensor(mu, dtype=dtype)
        x = torch.linspace(0.01, 3.0, 300, dtype=dtype)
        k0, k1, terms = bessel._temme_kmu(m, x, terms=True)
        a0, a1 = bessel._temme_kmu(m, x)
        assert torch.equal(k0, a0) and torch.equal(k1, a1)
        assert 3 <= terms.min() and terms.max() <= 40
        assert bool((terms.diff() >= 0).all())
        x = torch.linspace(3.01, 60.0, 300, dtype=dtype)
        k0, k1, steps = bessel._cf2_kmu(m, x, steps=True)
        a0, a1 = bessel._cf2_kmu(m, x)
        assert torch.equal(k0, a0) and torch.equal(k1, a1)
        assert 1 <= steps.min() and steps.max() < 63


def test_log_kv_grads_match_jax():
    """d/dx is the exact recurrence (same arithmetic: 1e-10 of the largest
    entry); d/dnu is a central difference over 2h = 6e-6, which divides the
    log_kv difference above by 6e-6 (1e-6 of the largest entry)."""
    N, X = _grid()
    w = np.random.default_rng(0).normal(size=N.shape)
    nt = torch.tensor(N, requires_grad=True)
    xt = torch.tensor(X, requires_grad=True)
    (bessel.log_kv(nt, xt) * torch.as_tensor(w)).sum().backward()
    gn, gx = jax.grad(lambda a, b: jnp.sum(jax_bessel.log_kv(a, b) * w),
                      argnums=(0, 1))(jnp.asarray(N), jnp.asarray(X))
    gn, gx = np.asarray(gn), np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0,
                               atol=1e-10 * np.abs(gx).max())
    np.testing.assert_allclose(nt.grad.numpy(), gn, rtol=0,
                               atol=1e-6 * np.abs(gn).max())


def test_log_kv_scalar_nu_grad_is_reduced():
    x = np.linspace(0.01, 10.0, 50)
    nu = torch.tensor(0.8, requires_grad=True)
    bessel.log_kv(nu, torch.as_tensor(x)).sum().backward()
    ref = jax.grad(lambda a: jnp.sum(jax_bessel.log_kv(a, jnp.asarray(x))))(
        0.8)
    assert nu.grad.shape == ()
    np.testing.assert_allclose(nu.grad.item(), float(ref), rtol=1e-6)


def _dist(n=400, seed=3):
    d = np.random.default_rng(seed).uniform(0.0, 1.5, size=n)
    d[:9] = 0.0
    return d


def _value_and_vjp(fn_t, fn_j, dist, cp):
    """(value, d dist, d covparms) of both packages for a random cotangent."""
    g = np.random.default_rng(1).normal(size=dist.shape)
    dt = torch.tensor(dist, requires_grad=True)
    ct = torch.tensor(cp, requires_grad=True)
    vt = fn_t(dt, ct)
    vt.backward(torch.as_tensor(g))
    vj, vjp = jax.vjp(fn_j, jnp.asarray(dist), jnp.asarray(cp))
    dd, dc = vjp(jnp.asarray(g))
    dct = ct.grad if ct.grad is not None else torch.zeros_like(ct)
    return ((vt.detach().numpy(), dt.grad.numpy(), dct.numpy()),
            (np.asarray(vj), np.asarray(dd), np.asarray(dc)))


@pytest.mark.parametrize("nu", [0.3, 0.8, 2.0, 0.5, 2.5])
def test_matern_value_and_vjp_match_jax(nu):
    """Off the closed forms d/dnu is a central difference of log K_nu on
    both sides (1e-6 relative); every other entry 1e-11 relative."""
    cp = np.array([1.3, 0.25, nu])
    ours, ref = _value_and_vjp(covariance.matern, jax_cov.matern,
                               _dist(), cp)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-11,
                                   atol=1e-13 * np.abs(b).max())
    np.testing.assert_allclose(ours[2][:2], ref[2][:2], rtol=1e-11)
    if nu in (0.5, 2.5):
        assert ours[2][2] == ref[2][2] == 0.0
    else:
        np.testing.assert_allclose(ours[2][2], ref[2][2], rtol=1e-6)


def test_esqe_value_and_vjp_match_jax():
    cp = np.array([0.8, 0.3, 0.4, 0.2])
    ours, ref = _value_and_vjp(covariance.esqe, jax_cov.esqe, _dist(), cp)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-15)


def _exp_dist_t(dist, covparms):
    return covparms[0] * torch.exp(-dist / covparms[1])


def _exp_dist_j(dist, covparms):
    return covparms[0] * jnp.exp(-dist / covparms[1])


def _exp_locs_t(locs1, locs2, covparms):
    return _exp_dist_t(covariance.safe_dist(((locs1 - locs2) ** 2).sum(-1)),
                       covparms)


def _exp_locs_j(locs1, locs2, covparms):
    return _exp_dist_j(jax_cov._safe_dist(jnp.sum((locs1 - locs2) ** 2, -1)),
                       covparms)


@pytest.mark.parametrize("kind", ["dist", "dist_1arg", "locs", "locs_2arg"])
def test_user_callables_match_jax(kind):
    """make_kernel_fn resolves both callable kinds as the JAX package does;
    values and the covparms cotangent agree."""
    rng = np.random.default_rng(4)
    cp = np.array([1.1, 0.3])
    if kind.startswith("dist"):
        ft, fj = ((lambda d: 1.1 * torch.exp(-d / 0.3)),
                  (lambda d: 1.1 * jnp.exp(-d / 0.3))) \
            if kind == "dist_1arg" else (_exp_dist_t, _exp_dist_j)
        kt, kj = covariance.make_kernel_fn(ft), jax_cov.make_kernel_fn(fj)
        assert not getattr(kt, "takes_locs", False)
        ours, ref = _value_and_vjp(kt, kj, _dist(), cp)
    else:
        if kind == "locs":
            ft, fj = _exp_locs_t, _exp_locs_j
        else:
            def ft(locs1, locs2):
                return _exp_locs_t(locs1, locs2, (1.1, 0.3))

            def fj(locs1, locs2):
                return _exp_locs_j(locs1, locs2, (1.1, 0.3))
        kt, kj = covariance.make_kernel_fn(ft), jax_cov.make_kernel_fn(fj)
        assert kt.takes_locs and kj.takes_locs
        a, b = rng.uniform(size=(2, 300, 2))
        a[:5] = b[:5]
        ct = torch.tensor(cp, requires_grad=True)
        vt = kt(torch.as_tensor(a), torch.as_tensor(b), ct)
        g = rng.normal(size=300)
        vj, vjp = jax.vjp(lambda c: kj(jnp.asarray(a), jnp.asarray(b), c),
                          jnp.asarray(cp))
        ours = (vt.detach().numpy(),)
        ref = (np.asarray(vj), np.asarray(vjp(jnp.asarray(g))[0]))
        if kind == "locs":
            vt.backward(torch.as_tensor(g))
            ours += (ct.grad.numpy(),)
        else:
            assert not vt.requires_grad and not ref[1].any()
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x, y, rtol=1e-13, atol=1e-15)


def test_unknown_covmodel_raises():
    with pytest.raises(ValueError, match="not implemented"):
        covariance.make_kernel_fn("gauss")
    with pytest.raises(ValueError, match="string or callable"):
        covariance.make_kernel_fn(3)
