"""The port's ``vecchia_estimate`` vs the JAX package's, on the CPU.

Compared at the objective level (value and gradient at the default start,
which has smoothness 0.8 and so runs the general-smoothness path), then on
short optimizer runs: 10 L-BFGS-B iterations must reach a log-likelihood
within 1e-6 relative of the JAX package's run, and a few Adam steps must
follow optax's iterates.  Data: a dense Matern GP draw plus a constant
trend (as tests/test_estimate.py makes it), from a seed.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

import jax
import jax.numpy as jnp

from gpvecchia_tpu.fit import mle as jax_mle
from gpvecchia_tpu.inference.likelihood import loglik_core

import gpvecchia_torch as GT
from gpvecchia_torch.fit import mle

from reference_impl import matern_np

TRUE = (2.0, 0.2, 0.5)
NUG = 0.2


def _data(n=300, seed=7):
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    K = matern_np(cdist(locs, locs), TRUE)
    z = rng.multivariate_normal(np.zeros(n), K + NUG * np.eye(n))
    return locs, z + 1.0


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.mark.parametrize("X", ["constant", None, "user"])
def test_detrend_and_theta_ini_match_jax(data, X):
    locs, y = data
    if X == "user":
        X = np.column_stack([np.ones(len(y)), locs[:, 0]])
    ours, ref = mle._detrend(y, X), jax_mle._detrend(y, X)
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-14)
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-12)
    assert ours[2] == ref[2]
    np.testing.assert_array_equal(mle._theta_ini(ours[0], locs),
                                  jax_mle._theta_ini(ref[0], locs))


def test_objective_and_gradient_match_jax(data):
    """At the default start (nu = 0.8): value 1e-10 relative; gradient in
    log(sig2, rho, nugget) 1e-9 of |g|max, in log(nu) 1e-6 relative."""
    locs, y = data
    z = y - y.mean()
    lg0 = np.log(mle._theta_ini(z, locs))
    spec = GT.vecchia_specify(locs, 10)
    obj = mle.neg_loglik_fn(spec, z, 4, device="cpu")
    lgt = torch.tensor(lg0, requires_grad=True)
    v = obj(lgt)
    (g,) = torch.autograd.grad(v, lgt)

    from gpvecchia_tpu import vecchia_specify as jax_specify
    core, dev = loglik_core(jax_specify(locs, 10), "matern")
    n = len(z)

    def neg(lg, dev):
        theta = jnp.exp(lg)
        return -core(dev, jnp.asarray(z), theta[:3],
                     jnp.broadcast_to(theta[3], (n,)))

    vj, gj = jax.jit(jax.value_and_grad(neg))(jnp.asarray(lg0), dev)
    gj = np.asarray(gj)
    np.testing.assert_allclose(v.item(), float(vj), rtol=1e-10)
    keep = [0, 1, 3]
    np.testing.assert_allclose(g.numpy()[keep], gj[keep], rtol=0,
                               atol=1e-9 * np.abs(gj).max())
    np.testing.assert_allclose(g[2].item(), gj[2], rtol=1e-6)


def test_lbfgs_matches_jax(data):
    locs, y = data
    est = GT.vecchia_estimate(y, locs, m=10, max_iter=10, output_level=0,
                              device="cpu")
    ref = jax_mle.vecchia_estimate(y, locs, m=10, max_iter=10,
                                   output_level=0)
    assert est["trend"] == "constant" and est["n_iter"] > 0
    np.testing.assert_allclose(est["beta_hat"], ref["beta_hat"], rtol=1e-14)
    np.testing.assert_allclose(est["loglik"], ref["loglik"], rtol=1e-6)
    ll_true = GT.vecchia_likelihood(est["z"], est["spec"], TRUE, NUG,
                                    device="cpu")
    assert est["loglik"] >= ll_true


def test_adam_follows_optax(data):
    """Adam's iterates equal optax's default Adam driven by the JAX
    package (same lr 1e-2 rule, gradients equal to ~1e-11)."""
    locs, y = data
    est = GT.vecchia_estimate(y, locs, m=10, method="adam", max_iter=4,
                              output_level=0, device="cpu")
    ref = jax_mle.vecchia_estimate(y, locs, m=10, method="adam", max_iter=4,
                                   output_level=0)
    assert est["n_iter"] == ref["n_iter"] == 4
    np.testing.assert_allclose(est["theta_hat"], ref["theta_hat"],
                               rtol=1e-9)
    np.testing.assert_allclose(est["loglik"], ref["loglik"], rtol=1e-10)


def test_nelder_mead_runs(data):
    locs, y = data
    est = GT.vecchia_estimate(y, locs, m=10, method="nelder-mead",
                              max_iter=5, output_level=0, device="cpu")
    start = GT.vecchia_likelihood(
        est["z"], est["spec"], mle._theta_ini(est["z"], locs)[:3],
        mle._theta_ini(est["z"], locs)[3], device="cpu")
    assert est["n_iter"] == 5 and np.isfinite(est["theta_hat"]).all()
    assert est["loglik"] >= start


def test_estimate_takes_float32_and_other_covmodels(data):
    """dtype reaches the likelihood; a non-Matern model needs theta_ini."""
    locs, y = data
    est = GT.vecchia_estimate(y, locs, m=8, max_iter=2, output_level=0,
                              device="cpu", dtype=torch.float32)
    assert np.isfinite(est["loglik"])
    with pytest.raises(ValueError, match="theta_ini"):
        GT.vecchia_estimate(y, locs, m=8, covmodel="esqe", output_level=0,
                            device="cpu")
    est = GT.vecchia_estimate(y, locs, m=8, covmodel="esqe", max_iter=2,
                              theta_ini=(1.0, 0.1, 0.5, 0.3, 0.2),
                              output_level=0, device="cpu")
    assert est["theta_hat"].shape == (5,)
    with pytest.raises(ValueError, match="unknown method"):
        GT.vecchia_estimate(y, locs, m=8, method="sgd", output_level=0,
                            device="cpu")
