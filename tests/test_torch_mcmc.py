"""HMC/NUTS hyperparameter sampling: the port vs the JAX package on the CPU
in float64.

The port's transitions take a key source; ``JaxKeys`` below draws through
``jax.random`` (test side only), so the port consumes the JAX package's
own stream and must reproduce its trajectories draw for draw: theta and
the acceptance statistic to 1e-12, on Gaussian targets and on a small
Vecchia posterior.  The moment and calibration checks of
``tests/test_mcmc.py`` run through the port too, marked slow as those are.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpvecchia_tpu as GJ
from gpvecchia_tpu.fit import mcmc as JM
from gpvecchia_tpu.inference.likelihood import loglik_core

import gpvecchia_torch as GT
from gpvecchia_torch.fit import mcmc as TM
from gpvecchia_torch.parallel import mesh as PM

import torch_mesh_ranks as MR

torch.set_default_dtype(torch.float64)

TOL = 1e-12          # a transition from the same inputs
CHAIN_TOL = 1e-9     # an adaptive chain (test_run_hmc_matches_jax)
VG_ACCEPT_REL = 1e-9  # acceptance on the Vecchia posterior


class JaxKeys:
    """The port's key-source interface over ``jax.random``."""

    def key(self, seed):
        return jax.random.PRNGKey(seed)

    def split(self, key, num=2):
        return list(jax.random.split(key, num))

    def normal(self, key, shape):
        return np.asarray(jax.random.normal(key, shape, jnp.float64))

    def uniform(self, key):
        return float(jax.random.uniform(key, dtype=jnp.float64))

    def bernoulli(self, key):
        return bool(jax.random.bernoulli(key))

    def randint(self, key, lo, hi):
        return int(jax.random.randint(key, (), lo, hi))


def _gaussian(mean, cov):
    """(JAX log density, the port's value+grad) of N(mean, cov)."""
    mean, prec = np.asarray(mean, float), np.linalg.inv(cov)

    def lp_j(th):
        d = th - jnp.asarray(mean)
        return -0.5 * d @ jnp.asarray(prec) @ d

    def vg_t(th):
        d = th - mean
        return float(-0.5 * d @ prec @ d), -(prec @ d)

    return lp_j, vg_t


TARGETS = {
    "diagonal": ([1.0, -2.0], np.diag([0.25, 4.0])),
    "correlated": ([0.0, 0.0], np.array([[1.0, 0.6], [0.6, 0.5]])),
}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=0, atol=TOL)


def test_leapfrog_kinetic_uturn_match_jax():
    lp_j, vg_t = _gaussian(*TARGETS["correlated"])
    th, r = np.array([0.3, -0.4]), np.array([1.1, 0.2])
    im = np.array([0.7, 1.3])
    got = TM._leapfrog(lambda t: vg_t(t)[1], th, r, 0.2, im)
    want = JM._leapfrog(jax.grad(lp_j), jnp.asarray(th), jnp.asarray(r), 0.2,
                        jnp.asarray(im))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-14)
    np.testing.assert_allclose(TM._kinetic(r, im),
                               float(JM._kinetic(jnp.asarray(r),
                                                 jnp.asarray(im))),
                               rtol=1e-14)
    for tp, tm in ((th, -th), (-th, th), (th, th + [0.1, -0.3])):
        assert TM._uturn(tp, tm, r, -r, im) == bool(JM._uturn(
            jnp.asarray(tp), jnp.asarray(tm), jnp.asarray(r),
            jnp.asarray(-r), jnp.asarray(im)))


@pytest.mark.parametrize("max_depth", [1, 3, 5])
@pytest.mark.parametrize("target", list(TARGETS))
def test_nuts_transition_matches_jax(target, max_depth):
    lp_j, vg_t = _gaussian(*TARGETS[target])
    th0, im = np.array([0.3, -0.2]), np.array([0.8, 1.5])
    for seed, eps in ((3, 0.4), (4, 0.9), (5, 0.05)):
        key = jax.random.PRNGKey(seed)
        want = JM._nuts_transition(lp_j, None, key, jnp.asarray(th0), eps,
                                   jnp.asarray(im), max_depth)
        got = TM._nuts_transition(vg_t, JaxKeys(), key, th0, eps, im,
                                  max_depth)
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("eps, ended", [(1e-3, None), (0.9, "turned"),
                                         (1e3, "diverged")])
def test_nuts_info_reports_how_the_trajectory_ended(eps, ended):
    """``info`` names the doublings run and why the trajectory ended; the
    value+grads are 1 + 2**depth - 1 (a subtree runs all its steps)."""
    _, vg = _gaussian(*TARGETS["correlated"])
    calls = [0]

    def vg_t(th):
        calls[0] += 1
        return vg(th)

    info = {}
    TM._nuts_transition(vg_t, TM.TorchKeys(), 11, np.array([0.3, -0.2]),
                        eps, np.ones(2), 5, info=info)
    assert info["diverged"] == (ended == "diverged")
    assert info["turned"] == (ended == "turned")
    assert (info["depth"] == 5) == (ended is None)
    assert calls[0] == 2 ** info["depth"]


def test_logpost_value_grad_without_prior():
    """``log_prior=None`` is no prior: the log-likelihood alone."""
    st, _, z, _, _, center = _vecchia_posterior()
    zero = TM.logpost_value_grad(
        st, z, log_prior=lambda lg: torch.zeros((), dtype=torch.float64),
        dim=4, device="cpu")
    none = TM.logpost_value_grad(st, z, dim=4, device="cpu")
    for a, b in zip(none(center), zero(center)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("target", list(TARGETS))
def test_hmc_transition_matches_jax(target):
    lp_j, vg_t = _gaussian(*TARGETS[target])
    th0, im = np.array([0.3, -0.2]), np.array([0.8, 1.5])
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = JM._hmc_transition(lp_j, None, key, jnp.asarray(th0), 0.3,
                                  jnp.asarray(im), 8)
        got = TM._hmc_transition(vg_t, JaxKeys(), key, th0, 0.3, im, 8)
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("seed", [3, 7, 8])
@pytest.mark.parametrize("algorithm", ["nuts", "hmc"])
def test_run_hmc_matches_jax(algorithm, seed, monkeypatch):
    """A short adaptive chain (20 warmup draws, 10 samples).  Every
    transition the port's chain runs equals the JAX package's transition
    from the same theta, key, step size and mass matrix to 1e-12; the
    chain's draws, acceptance statistics and step size equal the JAX
    chain's to CHAIN_TOL.  The adaptation feeds each transition's
    acceptance statistic back into the next step size, so last-bit
    differences of the two runtimes' arithmetic grow along a chain: on
    these seeds the draws agree to 7.2e-15 (seed 3), 2.3e-13 and 1.6e-10
    (seeds 7 and 8; with the target's value and gradient taken from JAX
    itself too, 8.1e-11)."""
    lp_j, vg_t = _gaussian(*TARGETS["correlated"])
    key = jax.random.PRNGKey(seed)
    kw = dict(num_warmup=20, num_samples=10, algorithm=algorithm,
              max_depth=4, n_leap=8)
    name = "_nuts_transition" if algorithm == "nuts" else "_hmc_transition"
    port_trans, calls = getattr(TM, name), []

    def record(vg, rng, k, th, eps, im, arg):
        out = port_trans(vg, rng, k, th, eps, im, arg)
        calls.append((k, th, eps, im, arg, out))
        return out

    monkeypatch.setattr(TM, name, record)
    st, at, et = TM.run_hmc(vg_t, np.zeros(2), key, JaxKeys(), **kw)
    assert len(calls) == 30
    jax_trans = jax.jit(functools.partial(getattr(JM, name), lp_j, None),
                        static_argnums=(4,))
    for k, th, eps, im, arg, (th_new, astat) in calls:
        want = jax_trans(k, jnp.asarray(th), eps, jnp.asarray(im), arg)
        _close(th_new, want[0])
        _close(astat, want[1])
    sj, aj, ej = JM.run_hmc(lp_j, jnp.zeros(2), key, **kw)
    assert st.shape == (10, 2) and at.shape == (10,)
    for a, b in ((st, sj), (at, aj), (et, ej)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=CHAIN_TOL)


def _vecchia_posterior(n=60, m=5, seed=3):
    """(port spec, JAX spec, z, JAX log posterior, port value+grad, prior
    centre) of the log Matern parameters and log nugget under a normal
    prior."""
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    z = rng.normal(size=n)
    st, sj = GT.vecchia_specify(locs, m=m), GJ.vecchia_specify(locs, m=m)
    center = np.log([1.0, 0.3, 0.5, 0.1])
    core, dev = loglik_core(sj, "matern", jnp.float64)
    zj = jnp.asarray(z)

    def lp_j(lg):
        th = jnp.exp(lg)
        return (core(dev, zj, th[:3], jnp.broadcast_to(th[3], (n,)))
                - 0.5 * jnp.sum((lg - jnp.asarray(center)) ** 2 / 4.0))

    ct = torch.as_tensor(center)
    vg_t = TM.logpost_value_grad(
        st, z, log_prior=lambda lg: -0.5 * torch.sum((lg - ct) ** 2 / 4.0),
        dim=4, device="cpu")
    return st, sj, z, lp_j, vg_t, center


def test_hmc_transition_on_vecchia_posterior_matches_jax():
    """One HMC transition (n_leap 2) on the Vecchia posterior: theta to
    1e-12, the acceptance probability to VG_ACCEPT_REL.  That probability
    is exp of a difference of two log posteriors of ~90 that agree to
    ~1e-13 relative, so it carries ~1e-11 of their rounding (2.3e-11
    measured)."""
    _, _, _, lp_j, vg_t, center = _vecchia_posterior()
    im = np.ones(4)
    trans = jax.jit(lambda k, th: JM._hmc_transition(
        lp_j, None, k, th, 0.05, jnp.asarray(im), 2))
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = trans(key, jnp.asarray(center))
        got = TM._hmc_transition(vg_t, JaxKeys(), key, center, 0.05, im, 2)
        _close(got[0], want[0])
        np.testing.assert_allclose(got[1], float(want[1]),
                                   rtol=VG_ACCEPT_REL)


def test_nonfinite_theta_is_a_divergence():
    """A step to a theta where the likelihood is not finite (overflowing
    exp(lg), a NaN smoothness) is a divergent step: the transition returns
    without raising and keeps its start."""
    *_, vg_t, center = _vecchia_posterior()
    for lg in (center + [800.0, 0, 0, 0], center + [0, 0, np.nan, 0]):
        v, g = vg_t(lg)
        assert not np.isfinite(v) or not np.all(np.isfinite(g))
    th0 = np.array(center)
    for seed in range(3):
        info = {}
        th, astat = TM._nuts_transition(vg_t, TM.TorchKeys(), seed, th0,
                                        400.0, np.ones(4), 3, info=info)
        np.testing.assert_array_equal(th, th0)
        assert info == dict(depth=1, diverged=True, turned=False)
        th, acc = TM._hmc_transition(vg_t, TM.TorchKeys(), seed, th0, 400.0,
                                     np.ones(4), 3)
        np.testing.assert_array_equal(th, th0)
        assert acc == 0.0


def test_sample_posterior_vecchia_smoke():
    """tests/test_mcmc.py's smoke test through the port."""
    rng = np.random.default_rng(3)
    n = 60
    locs = rng.uniform(size=(n, 2))
    z = rng.normal(size=n)
    spec = GT.vecchia_specify(locs, m=5)
    out = TM.sample_posterior(spec, z, covmodel="matern",
                              theta_ini=[1.0, 0.3, 0.5, 0.1],
                              num_warmup=10, num_samples=10, num_chains=2,
                              algorithm="hmc", n_leap=4, device="cpu")
    s = out["samples"]
    assert s.shape == (2, 10, 4)
    assert out["accept_stats"].shape == (2, 10)
    assert out["step_size"].shape == (2,)
    assert np.all(np.isfinite(s))
    assert np.all(s > 0)  # exp scale
    # the chain must actually move
    assert np.std(out["samples_log"][:, :, 0]) > 1e-4


def test_sample_posterior_keys_follow_jax():
    """With the JAX key source, sample_posterior's chains start where the
    JAX package's do and run the same transitions (NUTS, fixed nugget, the
    smoothness sampled: the general Matern), to CHAIN_TOL: the adaptation
    carries the likelihoods' ~1e-13 differences along (3.2e-10 measured
    with 4 warmup draws and 3 samples)."""
    st, sj, z, *_ = _vecchia_posterior(n=40, m=4, seed=5)
    kw = dict(nuggets=0.1, theta_ini=[1.0, 0.3, 0.8], num_warmup=2,
              num_samples=2, num_chains=2, seed=11, max_depth=2)
    got = TM.sample_posterior(st, z, rng=JaxKeys(), device="cpu", **kw)
    want = JM.sample_posterior(sj, z, **kw)
    assert got["samples"].shape == (2, 2, 3)
    for k in ("samples_log", "accept_stats", "step_size"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=CHAIN_TOL)


@pytest.fixture(scope="module")
def mesh_chains():
    """sample_posterior over a (chains=2, rows=1) mesh of 2 gloo ranks
    (``torch_mesh_ranks.chains_rank``; one spawn), each rank's result."""
    return PM.run_local(MR.chains_rank, 2, backend="gloo", device="cpu",
                        timeout=300.0)


def test_sample_posterior_mesh_matches_unsharded(mesh_chains):
    """The chains spread over the chains axis: every rank returns both
    chains, and their draws, acceptance statistics and step sizes equal
    those of mesh=None bit for bit (the same code on the same keys)."""
    spec, z = MR.chain_problem()
    threads = torch.get_num_threads()
    MR.one_thread()                   # as the ranks run
    try:
        want = TM.sample_posterior(spec, z, num_chains=2, **MR.CHAIN_KW)
    finally:
        torch.set_num_threads(threads)
    for got in mesh_chains:
        assert got["samples"].shape == (2, MR.CHAIN_KW["num_samples"], 4)
        for k in ("samples", "samples_log", "accept_stats", "step_size"):
            np.testing.assert_array_equal(got[k], want[k])


def test_sample_posterior_mesh_needs_divisible_chains(mesh_chains):
    for got in mesh_chains:
        assert "3 chains do not divide over 2 chain ranks" in \
            got["indivisible"]


def test_torch_keys_are_deterministic():
    rng = TM.TorchKeys()
    k = rng.key(5)
    a, b = rng.split(k)
    assert rng.split(k) == [a, b] and a != b
    np.testing.assert_array_equal(rng.normal(a, (3,)), rng.normal(a, (3,)))
    assert rng.uniform(a) == rng.uniform(a) and 0.0 <= rng.uniform(b) < 1.0
    assert all(1 <= rng.randint(x, 1, 9) < 9 for x in rng.split(b, 20))


@pytest.mark.slow
@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_gaussian_target_moments(algorithm):
    """tests/test_mcmc.py's moment check through the port."""
    _, vg_t = _gaussian(*TARGETS["diagonal"])
    s, astats, eps = TM.run_hmc(vg_t, np.zeros(2), TM.TorchKeys().key(0),
                                num_warmup=400, num_samples=800,
                                algorithm=algorithm, max_depth=5, n_leap=16)
    assert eps > 0 and np.all(np.isfinite(s))
    np.testing.assert_allclose(s.mean(0), [1.0, -2.0], atol=0.3)
    np.testing.assert_allclose(s.std(0), [0.5, 2.0], rtol=0.35)
    assert 0.4 < float(np.mean(astats)) <= 1.0


@pytest.mark.slow
@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_sampler_calibration_gaussian(algorithm):
    """tests/test_mcmc.py's calibration check through the port."""
    mean, cov = TARGETS["correlated"]
    _, vg_t = _gaussian(mean, cov)
    s, _, _ = TM.run_hmc(vg_t, np.zeros(2), TM.TorchKeys().key(0),
                         num_warmup=400, num_samples=4000,
                         algorithm=algorithm)
    assert np.abs(s.mean(axis=0)).max() < 0.1
    assert np.abs(np.cov(s.T) - cov).max() < 0.12
