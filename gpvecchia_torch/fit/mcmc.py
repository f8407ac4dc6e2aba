"""Hyperparameter posterior sampling: adaptive HMC/NUTS over the port's
Vecchia log-likelihood.

The port of the JAX package's ``fit/mcmc.py`` (which compiles every chain
into one ``lax.scan`` and vmaps the chains).  Here the sampler is a host
loop over device value+grad calls: theta (2-4 log-parameters) stays on the
host in float64 (numpy), each leapfrog step calls the log-posterior's value
and gradient once (``torch.autograd`` through ``loglik_fn``, whose plan and
z-cache every step hits) and reads that one (value, grad) back.  Chains run
one after another.

The transitions are those of the JAX package, step for step: the doubling
trajectory with progressive multinomial sampling, the balanced-subtree
U-turn checks on a state stack, the divergence rule, dual averaging of the
step size and the Welford diagonal mass matrix.  Between doublings a
finished trajectory stops (the JAX package freezes its carry, which is the
same); inside a doubling every leapfrog step runs, as there, since the
acceptance statistic that adapts the step size sums over all of them.

Randomness is explicit: each function takes a key source (``rng``) with
``key(seed)``, ``split(key, num)``, ``normal(key, shape)``,
``bernoulli(key)``, ``uniform(key)`` and ``randint(key, lo, hi)``, and
splits and draws in exactly the order of the JAX code.  ``TorchKeys``
(keys are integers; each draw seeds a CPU ``torch.Generator``) is the
production source; a source backed by ``jax.random`` reproduces the JAX
package's draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..inference.likelihood import loglik_fn, resolve_device

__all__ = ["TorchKeys", "run_hmc", "sample_posterior"]


class TorchKeys:
    """Key-style draws from CPU ``torch.Generator``s.

    A key is an integer below 2**62; ``split`` and every draw seed a
    generator with the key, so the same key always gives the same draw and
    the keys a key splits into depend on it alone, as with ``jax.random``.
    """

    _SPAN = 1 << 62

    @staticmethod
    def _gen(key):
        return torch.Generator().manual_seed(int(key))

    def key(self, seed):
        return int(seed) % self._SPAN

    def split(self, key, num=2):
        return torch.randint(0, self._SPAN, (num,),
                             generator=self._gen(key)).tolist()

    def normal(self, key, shape):
        return torch.randn(shape, generator=self._gen(key),
                           dtype=torch.float64).numpy()

    def uniform(self, key):
        return float(torch.rand((), generator=self._gen(key),
                                dtype=torch.float64))

    def bernoulli(self, key):
        return self.uniform(key) < 0.5

    def randint(self, key, lo, hi):
        return int(torch.randint(lo, hi, (), generator=self._gen(key)))


def _leapfrog(grad_fn, theta, r, eps, inv_mass):
    r = r + 0.5 * eps * grad_fn(theta)
    theta = theta + eps * inv_mass * r
    r = r + 0.5 * eps * grad_fn(theta)
    return theta, r


def _kinetic(r, inv_mass):
    return 0.5 * np.sum(r * r * inv_mass)


def _uturn(theta_plus, theta_minus, r_plus, r_minus, inv_mass):
    d = theta_plus - theta_minus
    return bool((np.dot(d, inv_mass * r_plus) < 0)
                | (np.dot(d, inv_mass * r_minus) < 0))


def _subtree(vg_fn, rng, key_s, start, go_right, eps, inv_mass, joint0,
             n_leap, max_depth):
    """``n_leap`` leapfrog steps from ``start`` = (theta, r, grad) in one
    direction: the new endpoint, the subtree's log weight and multinomial
    proposal, its acceptance sum, whether it diverged or turned ('bad') and
    whether it diverged."""
    th, r, g = start
    dim = th.shape[0]
    scales = 2 ** np.arange(1, max_depth + 1)
    dirsgn = 1.0 if go_right else -1.0
    eps_d = eps if go_right else -eps
    log_w, prop, sum_a, bad, diverged = -np.inf, th, 0.0, False, False
    stk_th = np.zeros((max_depth, dim))
    stk_r = np.zeros((max_depth, dim))
    for i in range(n_leap):
        r_half = r + 0.5 * eps_d * g
        th = th + eps_d * inv_mass * r_half
        logp, g = vg_fn(th)
        r = r_half + 0.5 * eps_d * g
        delta = logp - _kinetic(r, inv_mass) - joint0
        diverged = diverged or bool(delta < -1000.0) or bool(np.isnan(delta))
        bad = bad or diverged
        # balanced-subtree U-turn checks: slot s saves the state that starts
        # a block of 2^s steps and is checked where that block ends
        save = (i % scales) == 0
        stk_th[save] = th
        stk_r[save] = r
        check = ((i + 1) % scales) == 0
        dth = (th[None, :] - stk_th) * dirsgn
        d_end = dth @ (inv_mass * r)
        d_beg = np.sum(dth * (inv_mass * stk_r), axis=-1)
        bad = bad or bool(np.any(check & ((d_end < 0) | (d_beg < 0))))
        # progressive multinomial sampling within the subtree (a NaN delta
        # has already marked the subtree bad)
        with np.errstate(invalid="ignore"):
            log_w_new = np.logaddexp(log_w, delta)
        key_s, ku = rng.split(key_s)
        take = np.log(rng.uniform(ku)) < delta - log_w_new
        if take and not bad:
            prop = th
        # min(exp(delta), 1), without overflowing at a large delta
        sum_a = sum_a + np.exp(np.minimum(delta, 0.0))
        log_w = log_w_new
    return (th, r, g), log_w, prop, sum_a, bad, diverged


def _nuts_transition(vg_fn, rng, key, theta0, eps, inv_mass, max_depth,
                     info=None):
    """One dynamic-length transition (doubling trajectory, multinomial).

    ``vg_fn(theta) -> (log posterior, its gradient)``, numpy float64.
    Returns (theta_new, accept_stat).  A dict ``info`` receives the
    doublings run ('depth') and how the trajectory ended ('diverged' or
    'turned': a U-turn inside a subtree or across the trajectory; both
    False when it ran all ``max_depth`` doublings without either)."""
    dim = theta0.shape[0]
    key, kr = rng.split(key)
    r0 = rng.normal(kr, (dim,)) * np.sqrt(1.0 / inv_mass)
    logp0, g0 = vg_fn(theta0)
    joint0 = logp0 - _kinetic(r0, inv_mass)

    plus = minus = (theta0, r0, g0)
    prop, log_sum_w, sum_acc, n_acc = theta0, 0.0, 0.0, 0
    ran, diverged, turned = 0, False, False
    for depth in range(max_depth):
        key, kdir, ksel = rng.split(key, 3)
        go_right = rng.bernoulli(kdir)
        key, ksub = rng.split(key)
        end, log_w_sub, prop_sub, sum_a, div, diverged = _subtree(
            vg_fn, rng, ksub, plus if go_right else minus, go_right, eps,
            inv_mass, joint0, 2 ** depth, max_depth)
        # merge the subtree into the trajectory (biased progressive
        # sampling); a subtree that diverged or turned inside contributes
        # neither weight nor proposal
        take_sub = np.log(rng.uniform(ksel)) < log_w_sub - log_sum_w
        if take_sub and not div:
            prop = prop_sub
        if not div:
            log_sum_w = np.logaddexp(log_sum_w, log_w_sub)
        if go_right:
            plus = end
        else:
            minus = end
        sum_acc = sum_acc + sum_a
        n_acc += 2 ** depth
        ran = depth + 1
        if div or _uturn(plus[0], minus[0], plus[1], minus[1], inv_mass):
            turned = not diverged
            break
    if info is not None:
        info.update(depth=ran, diverged=diverged, turned=turned)
    return prop, sum_acc / max(n_acc, 1)


def _hmc_transition(vg_fn, rng, key, theta0, eps, inv_mass, n_leap):
    """Plain HMC with a uniformly jittered number of leapfrog steps.
    Returns (theta_new, accept_prob)."""
    dim = theta0.shape[0]
    key, kr, kl, ka = rng.split(key, 4)
    r0 = rng.normal(kr, (dim,)) * np.sqrt(1.0 / inv_mass)
    steps = rng.randint(kl, 1, n_leap + 1)
    logp0, g0 = vg_fn(theta0)
    th, r, logp, g = theta0, r0, logp0, g0
    for _ in range(steps):
        r_half = r + 0.5 * eps * g
        th = th + eps * inv_mass * r_half
        logp, g = vg_fn(th)
        r = r_half + 0.5 * eps * g
    joint0 = logp0 - _kinetic(r0, inv_mass)
    joint = logp - _kinetic(r, inv_mass)
    delta = -np.inf if np.isnan(joint) else joint - joint0
    accept_prob = np.exp(np.minimum(delta, 0.0))
    take = rng.uniform(ka) < accept_prob
    return (th if take else theta0), accept_prob


def run_hmc(vg_fn, theta0, key, rng=None, num_warmup=500, num_samples=500,
            algorithm="nuts", max_depth=6, n_leap=32, target_accept=0.8,
            init_step_size=0.1):
    """Adaptive HMC/NUTS chain; returns (samples, accept_stats, step_size).

    ``vg_fn(theta) -> (log posterior, gradient)`` on numpy float64 arrays.
    Warmup: dual-averaging step size over all of it, the Welford diagonal
    mass matrix over its second half (Stan's windowing simplified to one
    window), as in the JAX package.  ``algorithm`` is 'nuts' or 'hmc'.
    """
    rng = TorchKeys() if rng is None else rng
    theta = np.asarray(theta0, np.float64)
    dim = theta.shape[0]

    def transition(k, theta, eps, inv_mass):
        if algorithm == "nuts":
            return _nuts_transition(vg_fn, rng, k, theta, eps, inv_mass,
                                    max_depth)
        return _hmc_transition(vg_fn, rng, k, theta, eps, inv_mass, n_leap)

    # ---- warmup: dual averaging + Welford ----
    mu = math.log(10.0 * init_step_size)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    key, kw = rng.split(key)
    warm_keys = rng.split(kw, num_warmup)
    half = num_warmup // 2
    log_eps, log_eps_bar, h_bar = math.log(init_step_size), 0.0, 0.0
    inv_mass = np.ones(dim)
    for part in (warm_keys[:half], warm_keys[half:]):
        # the second half restarts the count and the Welford sums
        t, w_mean, w_m2 = 0.0, np.zeros(dim), np.zeros(dim)
        for k in part:
            theta, astat = transition(k, theta, np.exp(log_eps), inv_mass)
            t = t + 1.0
            h_bar = ((1.0 - 1.0 / (t + t0)) * h_bar
                     + (target_accept - astat) / (t + t0))
            log_eps = mu - np.sqrt(t) / gamma * h_bar
            w = t ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            d = theta - w_mean
            w_mean = w_mean + d / t
            w_m2 = w_m2 + d * (theta - w_mean)
    var = w_m2 / max(t - 1.0, 1.0)
    inv_mass = np.where(var > 0, var, 1.0)   # inv mass = posterior variance
    eps = np.exp(log_eps_bar)

    # ---- sampling ----
    key, ks = rng.split(key)
    samples, astats = [], []
    for k in rng.split(ks, num_samples):
        theta, astat = transition(k, theta, eps, inv_mass)
        samples.append(theta)
        astats.append(astat)
    return (np.asarray(samples).reshape(num_samples, dim),
            np.asarray(astats, np.float64), eps)


def logpost_value_grad(spec, z, covmodel="matern", nuggets=None,
                       estimate_nugget=True, log_prior=None, dim=4, *,
                       device="cuda", dtype=torch.float64):
    """vg(lg) -> (log posterior, gradient) at the log-parameters ``lg``
    (numpy float64): the Vecchia log-likelihood on ``device`` in ``dtype``
    at theta = exp(lg) (covparms, then the nugget when it is estimated, else
    ``nuggets`` or 1e-8) plus ``log_prior(lg)`` (a torch function of a
    float64 tensor; None: no prior), differentiated by ``torch.autograd``.
    One value and one gradient come back to the host a call."""
    fn = loglik_fn(spec, covmodel, device=device, dtype=dtype)
    zt = torch.as_tensor(np.asarray(z, np.float64)).to(device, dtype)
    n_obs = spec.n_obs
    if nuggets is not None:
        nug_fixed = torch.as_tensor(np.broadcast_to(
            np.asarray(nuggets, np.float64), (n_obs,)).copy())
    elif estimate_nugget:
        nug_fixed = None
    else:
        nug_fixed = torch.full((n_obs,), 1e-8, dtype=torch.float64)

    def vg(lg):
        lgt = torch.tensor(lg, dtype=torch.float64, requires_grad=True)
        theta = torch.exp(lgt)
        if nug_fixed is None:
            ll = fn(zt, theta[:dim - 1], theta[dim - 1].expand(n_obs))
        else:
            ll = fn(zt, theta, nug_fixed)
        lp = ll.to("cpu", torch.float64)
        if log_prior is not None:
            lp = lp + log_prior(lgt)
        (g,) = torch.autograd.grad(lp, lgt)
        return float(lp.detach()), g.numpy()

    return vg


def sample_posterior(spec, z, nuggets=None, covmodel="matern",
                     log_prior=None, theta_ini=None, num_warmup=300,
                     num_samples=300, num_chains=4, seed=0, mesh=None,
                     algorithm="nuts", estimate_nugget=True, rng=None, *,
                     device="cuda", dtype=torch.float64, **hmc_kwargs):
    """Posterior over log Matern params (+ log nugget) given observations.

    The log posterior is the Vecchia log-likelihood on ``device`` plus
    ``log_prior`` (a torch function of the float64 log-parameters; default:
    a normal of variance 4 on each log-parameter around ``theta_ini``).
    ``num_chains`` adaptive chains run one after another from
    log(theta_ini) plus a jitter of 0.1 standard normals.  Returns a dict
    of numpy arrays: 'samples' (chains, draws, dim) on the original (exp)
    scale, 'samples_log', 'accept_stats' (chains, draws), 'step_size'
    (chains,).  ``rng`` is the key source (``TorchKeys`` by default).

    With ``mesh`` (``parallel.mesh.make_mesh``; every rank calls this with
    the same arguments) the chains are spread over its "chains" dimension
    in contiguous blocks (``num_chains`` must divide by its size), each
    chain with the key and start it has without a mesh, so the draws do not
    depend on the mesh; the ranks along "rows" of one block run the same
    chains, and every rank returns all of them.
    """
    block = range(num_chains)
    if mesh is not None:
        size = mesh["chains"].size()
        if num_chains % size:
            raise ValueError(f"sample_posterior: {num_chains} chains do not "
                             f"divide over {size} chain ranks")
        k = num_chains // size
        c = mesh.get_local_rank("chains")
        block = range(c * k, (c + 1) * k)
    device = resolve_device(device)
    rng = TorchKeys() if rng is None else rng

    if theta_ini is None:
        zv = float(np.nanvar(np.asarray(z, np.float64), ddof=1))
        theta_ini = np.array([0.9 * zv, 0.3, 0.8] + ([0.1 * zv] if
                                                     estimate_nugget else []))
    theta_ini = np.asarray(theta_ini, np.float64)
    dim = theta_ini.size

    if log_prior is None:
        center = torch.as_tensor(np.log(theta_ini))

        def log_prior(lg):
            return -0.5 * torch.sum((lg - center) ** 2 / 4.0)

    vg = logpost_value_grad(spec, z, covmodel, nuggets, estimate_nugget,
                            log_prior, dim, device=device, dtype=dtype)
    chain_keys = rng.split(rng.key(seed), num_chains)
    jitter = rng.normal(rng.key(seed + 1), (num_chains, dim)) * 0.1
    theta0 = np.log(theta_ini)[None, :] + jitter
    runs = [run_hmc(vg, theta0[c], chain_keys[c], rng,
                    num_warmup=num_warmup, num_samples=num_samples,
                    algorithm=algorithm, **hmc_kwargs)
            for c in block]
    samples_log = np.stack([r[0] for r in runs])
    astats = np.stack([r[1] for r in runs])
    eps = np.asarray([r[2] for r in runs])
    if mesh is not None:
        samples_log, astats, eps = _gather_chains(
            mesh, device, block.start, num_chains, samples_log, astats, eps)
    return {"samples": np.exp(samples_log),
            "samples_log": samples_log,
            "accept_stats": astats,
            "step_size": eps}


def _gather_chains(mesh, device, c0, num_chains, *parts):
    """Every chain block's arrays (leading axis: its chains) on every rank,
    by the exact all-gather over the "chains" group (float64 on the
    rank's device, as the group's backend takes it)."""
    from ..parallel.mesh import RowShare
    share = RowShare(mesh.get_group("chains"), mesh["chains"].size(),
                     mesh.get_local_rank("chains"))
    k = parts[0].shape[0]
    flat = np.concatenate([p.reshape(k, -1) for p in parts], axis=1)
    whole = share.gather_rows(torch.as_tensor(flat).to(device), c0,
                              num_chains).cpu().numpy()
    out, pos = [], 0
    for p in parts:
        w = int(np.prod(p.shape[1:], dtype=np.int64))
        out.append(whole[:, pos:pos + w].reshape((num_chains,) + p.shape[1:]))
        pos += w
    return out
