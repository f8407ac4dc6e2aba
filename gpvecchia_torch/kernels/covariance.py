"""Covariance kernels on distance tensors (PyTorch).

The port of the JAX package's ``kernels/covariance.py``: the Matern
covariance (closed forms for smoothness 0.5, 1.5 and 2.5; any other
smoothness through log K_nu, ``kernels/bessel.py``) with the analytic VJP of
``_matern_bwd``, the exponential + squared-exponential ``esqe``, pairwise
distances, and ``make_kernel_fn``, which resolves a covariance model (a name
or a user callable of torch tensors) into an evaluator.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from .bessel import log_kv_impl, log_kv_vjp

__all__ = ["matern", "matern_dgds", "matern_general_dg", "nu_index", "esqe",
           "pairwise_dist", "cross_dist", "make_kernel_fn", "safe_dist"]

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.2360679774997896
GENERAL = 3                     # nu_index of a smoothness without closed form


def nu_index(nu) -> int:
    """0/1/2 for the closed forms at smoothness 0.5/1.5/2.5, ``GENERAL``
    (3) for any other smoothness.

    A tensor is read detached, on the host: the index selects code, and the
    closed forms are not differentiated in nu (d/dnu is 0 there, as in the
    JAX package)."""
    nu = float(nu.detach()) if torch.is_tensor(nu) else float(nu)
    return {0.5: 0, 1.5: 1, 2.5: 2}.get(nu, GENERAL)


def safe_dist(d2: torch.Tensor) -> torch.Tensor:
    """sqrt with zero at d2 == 0 (and a zero gradient there)."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def pairwise_dist(pts: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances of (..., k, d) -> (..., k, k)."""
    d = pts[..., :, None, :] - pts[..., None, :, :]
    return safe_dist((d * d).sum(-1))


def cross_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distances between (..., p, d) and (..., q, d) -> (..., p, q)."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return safe_dist((d * d).sum(-1))


def _correlation(s: torch.Tensor, idx: int) -> torch.Tensor:
    if idx == 0:
        return torch.exp(-s)
    if idx == 1:
        return (1.0 + _SQRT3 * s) * torch.exp(-_SQRT3 * s)
    return (1.0 + _SQRT5 * s + 5.0 * s * s / 3.0) * torch.exp(-_SQRT5 * s)


class _Matern(torch.autograd.Function):
    """sig2 * g(dist / rho); backward: the JAX package's ``_matern_bwd``."""

    @staticmethod
    def forward(ctx, dist, covparms, idx):
        sig2, rho, nu = covparms[0], covparms[1], covparms[2]
        s = dist / rho
        lk = None
        if idx != GENERAL:
            c = _correlation(s, idx)
        else:
            # 2^(1-nu)/Gamma(nu) * s^nu * K_nu(s)
            pos = s > 0
            s_safe = torch.where(pos, s, 1.0)
            lk = log_kv_impl(nu, s_safe)
            logc = ((1.0 - nu) * math.log(2.0) - torch.lgamma(nu)
                    + nu * torch.log(s_safe) + lk)
            c = torch.where(pos, torch.exp(logc), 1.0)
        c = sig2 * torch.where(dist > 0, c, 1.0)
        ctx.idx = idx
        ctx.save_for_backward(dist, covparms, c, lk)
        return c

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dist, covparms, c, lk = ctx.saved_tensors
        sig2, rho, nu = covparms[0], covparms[1], covparms[2]
        pos = dist > 0
        s = torch.where(pos, dist, 1.0) / rho
        G = c / sig2                      # the unit-variance correlation
        dcov = torch.zeros_like(covparms)
        if ctx.idx != GENERAL:
            dGds = _dgds(s, G, ctx.idx)
        else:
            # the forward's log K_nu(s) is the same value at every pos element
            dGds, dGdnu = _general_dG(s, nu, G, lk)
            dcov[2] = torch.sum(g * sig2 * torch.where(pos, dGdnu, 0.0))
        dGds = torch.where(pos, dGds, 0.0)
        dcov[0] = torch.sum(g * G)
        dcov[1] = torch.sum(g * (sig2 * dGds) * (-(s / rho)))  # ds/drho
        ddist = g * sig2 * dGds / rho if ctx.needs_input_grad[0] else None
        return ddist, dcov, None


def _general_dG(s, nu, G, lk):
    """(dG/ds, dG/dnu) of G = 2^(1-nu)/Gamma(nu) s^nu K_nu(s) at s > 0,
    given G and lk = log K_nu(s): dG/ds = G (nu/s + dlogK/ds) and dG/dnu =
    G (-log 2 - digamma(nu) + log s + dlogK/dnu), by ``log_kv_vjp``."""
    dlks, dlkn = log_kv_vjp(nu, s, lk)
    return (G * (nu / s + dlks),
            G * (-math.log(2.0) - torch.special.digamma(nu) + torch.log(s)
                 + dlkn))


def _dgds(s, G, idx):
    """dG/ds of the closed forms (``_d05/_d15/_d25`` of the JAX package)."""
    if idx == 0:
        return -G
    if idx == 1:
        return -3.0 * s * torch.exp(-_SQRT3 * s)
    return -(5.0 / 3.0) * s * (1.0 + _SQRT5 * s) * torch.exp(-_SQRT5 * s)


def matern(dist: torch.Tensor, covparms: torch.Tensor,
           idx: int | None = None) -> torch.Tensor:
    """Matern covariance sig2 * g(dist / rho) on a distance tensor.

    covparms = (variance, range, smoothness), a tensor.  ``idx`` is
    ``nu_index(covparms[2])``, read from covparms when not given.
    Differentiable in dist and covparms by the analytic VJP (d/dnu off the
    closed forms by a central difference of log K_nu)."""
    if idx is None:
        idx = nu_index(covparms[2])
    return _Matern.apply(dist, covparms, idx)


def matern_dgds(dist: torch.Tensor, rho, idx: int):
    """(g, dg/ds) of a closed form at s = dist / rho, with g = 1 and dg/ds
    = 0 at dist == 0: then d/dsig2 of sig2 g(s) is g and d/drho is
    sig2 g'(s) (-s / rho)."""
    pos = dist > 0
    s = torch.where(pos, dist, 1.0) / rho
    g = _correlation(s, idx)
    return (torch.where(pos, g, 1.0),
            torch.where(pos, _dgds(s, g, idx), 0.0))


def matern_general_dg(dist: torch.Tensor, rho, nu):
    """(g, dg/ds, dg/dnu) of the Matern at a smoothness without closed form,
    at s = dist / rho, with g = 1 and both derivatives 0 at dist == 0: the
    forward and the VJP rule of ``_Matern`` (dg/ds through K_{nu+1}/K_nu,
    dg/dnu by the central difference of ``bessel.log_kv_vjp``)."""
    pos = dist > 0
    s = torch.where(pos, dist, 1.0) / rho
    lk = log_kv_impl(nu, s)
    g = torch.exp((1.0 - nu) * math.log(2.0) - torch.lgamma(nu)
                  + nu * torch.log(s) + lk)
    dgds, dgdnu = _general_dG(s, nu, g, lk)
    return (torch.where(pos, g, 1.0), torch.where(pos, dgds, 0.0),
            torch.where(pos, dgdnu, 0.0))


def esqe(dist: torch.Tensor, covparms: torch.Tensor) -> torch.Tensor:
    """Exponential + squared-exponential sum kernel; covparms = (var1,
    range1, var2, range2)."""
    v1, r1, v2, r2 = covparms[0], covparms[1], covparms[2], covparms[3]
    s1 = dist / r1
    s2 = dist / r2
    return v1 * torch.exp(-s1) + v2 * torch.exp(-(s2 * s2))


def make_kernel_fn(covmodel) -> Callable:
    """Resolve a covariance model into a covariance evaluator.

    Accepts 'matern', 'esqe', or a callable of torch tensors:
      * f(dist) or f(dist, covparms), evaluated on distance tensors;
      * f(locs1, locs2) or f(locs1, locs2, covparms) with a first parameter
        named 'locs1'/'loc1'/'x1', evaluated on broadcastable (..., d)
        location-pair tensors.  The returned function carries
        ``takes_locs = True`` so callers feed coordinates.
    """
    if isinstance(covmodel, str):
        if covmodel == "matern":
            return matern
        if covmodel == "esqe":
            return esqe
        raise ValueError(f"covariance model '{covmodel}' is not implemented")
    if callable(covmodel):
        try:
            params = list(inspect.signature(covmodel).parameters)
        except (TypeError, ValueError):
            params = ["dist", "covparms"]
        if params and params[0] in ("locs1", "loc1", "x1"):
            if len(params) == 2:
                def fn(a, b, covparms):
                    return covmodel(a, b)
            else:
                def fn(a, b, covparms):
                    return covmodel(a, b, covparms)
            fn.takes_locs = True
            return fn
        if len(params) == 1:
            return lambda dist, covparms: covmodel(dist)
        return covmodel
    raise ValueError("covmodel must be a string or callable")
