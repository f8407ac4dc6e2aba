"""log K_nu(x), the modified Bessel function of the second kind, in PyTorch.

A port of the JAX package's ``kernels/bessel.py`` (XLA code there, not a
Pallas kernel): write nu = mu + k with mu in [-1/2, 1/2] and integer k >= 0,
compute K_mu and K_{mu+1} by Temme's series for x <= 3 (40 terms) or Steed's
continued fraction CF2 for x > 3 (at most 64 steps, converged lanes frozen),
then climb to K_nu with the ratio recurrence r_{j+1} = 2(mu+j)/x + 1/r_j in
log space (at most 24 steps).  The iteration counts and the guards
(``small_pimu``, ``small_e``, ``small_mu``, ``an == 0``, ``x_safe``) are the
JAX package's, so every element gets the same arithmetic.

Three things differ from the JAX code and change no element's value:

* each branch runs only on the elements that take it (the JAX code runs
  both on every element and selects);
* the climb runs only as many steps as the largest k needs (the JAX loop
  runs all 23 and leaves an element unchanged once its k is reached);
* CF2 stops once every element has converged (the JAX loop keeps running
  with all lanes frozen), and freezes only the two values it returns
  (h and s): the other recurrences of a converged element are never read
  again.

``log_kv`` is a ``torch.autograd.Function`` with the JAX package's custom
VJP: d/dx = nu/x - K_{nu+1}/K_nu, and d/dnu a central difference of two
evaluations at nu + h and |nu - h| (h = 3e-6 in float64, 1e-3 in float32).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

__all__ = ["log_kv", "log_kv_impl", "log_kv_vjp", "nu_step"]

_EULER_GAMMA = 0.5772156649015329
_C3 = -0.04200263503409524  # z^3 coefficient of 1/Gamma(1+z)
_SERIES_ITERS = 40
_CF_ITERS = 64
_MAX_CLIMB = 24


def nu_step(dtype: torch.dtype) -> float:
    """The central-difference step in nu of the d/dnu derivatives."""
    return 3e-6 if dtype == torch.float64 else 1e-3


def _rgamma(z):
    """1/Gamma(z) for z in (0.4, 1.6) via lgamma (Gamma > 0 there)."""
    return torch.exp(-torch.lgamma(z))


def _temme_mu(mu):
    """What Temme's series needs of mu alone, with its guards: (pi mu /
    sin(pi mu), gamma_1, gamma_2, 1/Gamma(1+mu), 1/Gamma(1-mu)).  The
    general Matern's kernels take these once a launch
    (``matern_solve.general_params``)."""
    mu2 = mu * mu
    pimu = math.pi * mu
    small_pimu = torch.abs(pimu) < 1e-3
    pimu_s = torch.where(small_pimu, 1.0, pimu)
    fact = torch.where(small_pimu, 1.0 + pimu * pimu / 6.0,
                       pimu_s / torch.sin(pimu_s))
    gampl = _rgamma(1.0 + mu)   # 1/Gamma(1+mu)
    gammi = _rgamma(1.0 - mu)   # 1/Gamma(1-mu)
    small_mu = torch.abs(mu) < 3e-2
    mu_s = torch.where(small_mu, 1.0, mu)
    gam1 = torch.where(small_mu, -(_EULER_GAMMA + _C3 * mu2),
                       (gammi - gampl) / (2.0 * mu_s))
    gam2 = (gammi + gampl) / 2.0
    return fact, gam1, gam2, gampl, gammi


def _temme_kmu(mu, x, terms=False):
    """(K_mu(x), K_{mu+1}(x)) via Temme's series; accurate for 0 < x <= 3.
    ``mu`` is 0-dim or has x's shape.  ``terms``: also the count of terms
    after which the general Matern's kernels leave the series at each x
    (``csrc/matern_common.cuh`` ``log_kv``: from the third term on, once a
    term and its bound for K_{mu+1} are at most an eighth of an ulp of
    x's dtype of their sums; 40 where none is)."""
    mu2 = mu * mu
    x2 = x * 0.5
    fact, gam1, gam2, gampl, gammi = _temme_mu(mu)
    d = -torch.log(x2)
    e = mu * d
    small_e = torch.abs(e) < 1e-3
    e_s = torch.where(small_e, 1.0, e)
    fact2 = torch.where(small_e, 1.0 + e * e / 6.0, torch.sinh(e_s) / e_s)

    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    ee = torch.exp(e)
    p = 0.5 * ee / gampl
    q = 0.5 / (ee * gammi)
    c = torch.ones_like(x)
    d2 = x2 * x2
    ksum = ff
    ksum1 = p
    if terms:
        qulp = torch.finfo(x.dtype).eps / 8.0
        n_terms = torch.full_like(x, float(_SERIES_ITERS))
        left = torch.zeros_like(x, dtype=torch.bool)
    for i in range(1, _SERIES_ITERS + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu2)
        c = c * d2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        ksum = ksum + c * ff
        ksum1 = ksum1 + c * (p - fi * ff)
        if terms and i >= 3:
            now = ~left & ((c * ff).abs() <= qulp * ksum.abs()) & (
                c * (p.abs() + fi * ff.abs()) <= qulp * ksum1.abs())
            n_terms[now] = fi
            left |= now
    if terms:
        return ksum, ksum1 * 2.0 / x, n_terms
    return ksum, ksum1 * 2.0 / x


def _cf2_kmu(mu, x, steps=False):
    """(K_mu(x) e^x, K_{mu+1}(x) e^x) via Steed's CF2; accurate for x > 3.
    ``steps``: also the steps each element takes to converge (63 where it
    does not), as the general Matern's kernels take them."""
    mu2 = mu * mu
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    a1 = 0.25 - mu2
    q = a1
    c = a1
    a = -a1
    s = 1.0 + q * delh
    eps = 1e-16 if x.dtype == torch.float64 else 1e-8
    done = torch.zeros_like(x, dtype=torch.bool)
    n_steps = torch.full_like(x, float(_CF_ITERS - 1)) if steps else None
    for i in range(2, _CF_ITERS + 1):
        fi = float(i)
        an = a - 2.0 * (fi - 1.0)
        cn = -an * c / fi
        # a1 == 0 (half-integer mu) degenerates: c stays 0, so qnew is
        # unused; guard the division against 0/0
        qnew = (q1 - b * q2) / torch.where(an == 0.0, 1.0, an)
        qn = q + cn * qnew
        bn = b + 2.0
        dn = 1.0 / (bn + an * d)
        delhn = (bn * dn - 1.0) * delh
        hn = h + delhn
        dels = qn * delhn
        sn = s + dels
        new_done = done | (torch.abs(dels) < torch.abs(sn) * eps)
        if steps:
            n_steps[new_done & ~done] = fi - 1.0
        h = torch.where(done, h, hn)
        s = torch.where(done, s, sn)
        a, b, c, d, delh, q1, q2, q = an, bn, cn, dn, delhn, q2, qnew, qn
        done = new_done
        if bool(done.all()):
            break
    h = a1 * h
    kmu_s = torch.sqrt(math.pi / (2.0 * x)) / s
    kmu1_s = kmu_s * (mu + x + 0.5 - h) / x
    if steps:
        return kmu_s, kmu1_s, n_steps
    return kmu_s, kmu1_s


def _branch(mu, x_safe, mask, fn, scaled):
    """(log K_mu, log K_{mu+1}) of fn on the elements of ``mask``."""
    if mask is None:
        xs, ms = x_safe, mu
    else:
        xs = x_safe[mask]
        ms = mu if mu.dim() == 0 else mu[mask]
    k0, k1 = fn(ms, xs)
    if scaled:
        return torch.log(k0) - xs, torch.log(k1) - xs
    return torch.log(k0), torch.log(k1)


def log_kv_impl(nu, x: torch.Tensor) -> torch.Tensor:
    """log K_nu(x) elementwise, no autograd; ``nu`` a number or a tensor
    broadcastable to x's shape (the result has x's shape)."""
    dt = x.dtype
    nu = torch.as_tensor(nu, dtype=dt, device=x.device)
    if nu.dim() > 0 and nu.shape != x.shape:
        nu = nu.expand(x.shape)
    k = torch.clamp(torch.round(nu), 0, _MAX_CLIMB)
    mu = nu - k                                  # in [-1/2, 1/2]

    x_safe = torch.clamp(x, min=1e-30)
    small = x_safe <= 3.0
    n_small = int(small.sum())
    if n_small == x.numel():
        log_kmu, log_kmu1 = _branch(mu, x_safe, None, _temme_kmu, False)
    elif n_small == 0:
        log_kmu, log_kmu1 = _branch(mu, x_safe, None, _cf2_kmu, True)
    else:
        log_kmu = torch.empty_like(x)
        log_kmu1 = torch.empty_like(x)
        for mask, fn, scaled in ((small, _temme_kmu, False),
                                 (~small, _cf2_kmu, True)):
            log_kmu[mask], log_kmu1[mask] = _branch(mu, x_safe, mask, fn,
                                                    scaled)

    # climb from (mu, mu+1) to nu = mu + k in log space via ratios:
    # r_1 = K_{mu+1}/K_mu, r_{j+1} = 2(mu+j)/x + 1/r_j,
    # log K_{mu+k} = log K_mu + sum_{j=1..k} log r_j
    r = torch.exp(log_kmu1 - log_kmu)
    logk = log_kmu + torch.where(k > 0, torch.log(r), 0.0)
    for j in range(1, int(k.max())):
        r_new = 2.0 * (mu + j) / x_safe + 1.0 / r
        active = j < k                 # adds log r_{j+1} while j <= k-1
        logk = torch.where(active,
                           logk + torch.log(torch.where(active, r_new, 1.0)),
                           logk)
        r = torch.where(active, r_new, r)
    return torch.where(k > 0, logk, log_kmu)


def log_kv_vjp(nu, x, lk):
    """(d/dx, d/dnu) of log K_nu(x) elementwise, given lk = log K_nu(x):
    d/dx = nu/x - K_{nu+1}(x)/K_nu(x), and d/dnu a central difference at
    nu + h and |nu - h|.  The one rule of both ``log_kv``'s backward and
    the Matern's (``covariance._Matern``)."""
    glx = nu / torch.clamp(x, min=1e-30) - torch.exp(log_kv_impl(nu + 1.0, x)
                                                      - lk)
    h = nu_step(x.dtype)
    gln = (log_kv_impl(nu + h, x)
           - log_kv_impl(torch.abs(nu - h), x)) / (2.0 * h)
    return glx, gln


class _LogKv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nu, x):
        lk = log_kv_impl(nu, x)
        ctx.save_for_backward(nu, x, lk)
        return lk

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        nu, x, lk = ctx.saved_tensors
        glx, gln = log_kv_vjp(nu.to(x.dtype), x, lk)
        dnu = dx = None
        if ctx.needs_input_grad[0]:
            dnu = (g * gln).sum_to_size(nu.shape).to(nu.dtype)
        if ctx.needs_input_grad[1]:
            dx = (g * glx).sum_to_size(x.shape)
        return dnu, dx


def log_kv(nu, x: torch.Tensor) -> torch.Tensor:
    """log K_nu(x) elementwise for nu >= 0 (nu broadcasts against x),
    differentiable in nu and x."""
    if not torch.is_tensor(nu):
        nu = torch.tensor(nu, dtype=x.dtype, device=x.device)
    return _LogKv.apply(nu, x)
