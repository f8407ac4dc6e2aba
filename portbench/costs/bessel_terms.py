"""How many series terms and continued-fraction steps the port's general
Matern kernels take for log K_nu(x): a frozen copy of the counting parts
of the port's ``kernels/bessel.py`` (``_temme_mu``, ``_temme_kmu`` with
``terms``, ``_cf2_kmu`` with ``steps``) and of the orders
``matern_solve.general_params`` forms, for the yardstick's operation
counts."""

from __future__ import annotations

import math

import numpy as np
import torch

_EULER_GAMMA = 0.5772156649015329
_C3 = -0.04200263503409524  # z^3 coefficient of 1/Gamma(1+z)
_SERIES_ITERS = 40
_CF_ITERS = 64
_MAX_CLIMB = 24


def nu_step(dt) -> float:
    """The central-difference step in nu of the d/dnu derivatives."""
    return 3e-6 if dt == torch.float64 else 1e-3


def mus(nu, dt):
    """The three orders' mu (order - k, k = its nearest integer in [0,
    24]) of a launch at smoothness ``nu``: nu, nu + h and |nu - h|, each
    formed in ``dt``."""
    npt = np.float32 if dt == torch.float32 else np.float64
    nu_t = npt(nu)
    h = npt(nu_step(dt))
    orders = (nu_t, npt(nu_t + h), np.abs(npt(nu_t - h)))
    ks = [float(np.clip(np.round(o), 0, _MAX_CLIMB)) for o in orders]
    return [float(npt(o - npt(k))) for o, k in zip(orders, ks)]


def _temme_mu(mu):
    mu2 = mu * mu
    pimu = math.pi * mu
    small_pimu = torch.abs(pimu) < 1e-3
    pimu_s = torch.where(small_pimu, 1.0, pimu)
    fact = torch.where(small_pimu, 1.0 + pimu * pimu / 6.0,
                       pimu_s / torch.sin(pimu_s))
    gampl = torch.exp(-torch.lgamma(1.0 + mu))
    gammi = torch.exp(-torch.lgamma(1.0 - mu))
    small_mu = torch.abs(mu) < 3e-2
    mu_s = torch.where(small_mu, 1.0, mu)
    gam1 = torch.where(small_mu, -(_EULER_GAMMA + _C3 * mu2),
                       (gammi - gampl) / (2.0 * mu_s))
    gam2 = (gammi + gampl) / 2.0
    return fact, gam1, gam2, gampl, gammi


def temme_terms(mu, x):
    """The count of terms after which the kernels leave Temme's series at
    each x (0 < x <= 3): from the third term on, once a term and its bound
    for K_{mu+1} are at most an eighth of an ulp of x's dtype of their
    sums; 40 where none is."""
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
        if i >= 3:
            now = ~left & ((c * ff).abs() <= qulp * ksum.abs()) & (
                c * (p.abs() + fi * ff.abs()) <= qulp * ksum1.abs())
            n_terms[now] = fi
            left |= now
    return n_terms


def cf2_steps(mu, x):
    """The steps each element of x (> 3) takes to converge in Steed's CF2
    (63 where it does not)."""
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
    n_steps = torch.full_like(x, float(_CF_ITERS - 1))
    for i in range(2, _CF_ITERS + 1):
        if x.numel() == 0:
            break
        fi = float(i)
        an = a - 2.0 * (fi - 1.0)
        cn = -an * c / fi
        qnew = (q1 - b * q2) / torch.where(an == 0.0, 1.0, an)
        qn = q + cn * qnew
        bn = b + 2.0
        dn = 1.0 / (bn + an * d)
        delhn = (bn * dn - 1.0) * delh
        hn = h + delhn
        dels = qn * delhn
        sn = s + dels
        new_done = done | (torch.abs(dels) < torch.abs(sn) * eps)
        n_steps[new_done & ~done] = fi - 1.0
        h = torch.where(done, h, hn)
        s = torch.where(done, s, sn)
        a, b, c, d, delh, q1, q2, q = an, bn, cn, dn, delhn, q2, qnew, qn
        done = new_done
        if bool(done.all()):
            break
    return n_steps
