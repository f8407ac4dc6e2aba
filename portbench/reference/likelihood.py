"""The Gaussian Sparse General Vecchia log-likelihood and its gradient in
the log-parameters, in plain torch (GPvecchia R/vecchia_likelihood.R).

For each ordered point i, with neighbours NN[i] (self first), some
conditioned on through their latent and the rest through their response
(``cond``): the covariance of (y_i, the neighbours' y or z) is the Matern's,
plus the nugget on the diagonal of a response; solving it for e_0 and
scaling by the root of the first entry gives the U column.  Then

    -2 loglik = -2 sum_i log U_ii + n log(nugget) + log det W
                + |z1|^2 - z2^T W^{-1} z2 + n log(2 pi)

(``factor.py`` for W).  The Matern is sig2 2^(1-nu)/Gamma(nu) s^nu K_nu(s),
s = distance / range, exp(-s) at nu = 0.5; K_nu by the trapezoidal rule on
K_nu(x) = int_0^inf exp(-x cosh t) cosh(nu t) dt, which converges
geometrically for this integrand, with its derivatives in s and nu from the same
nodes.

The gradient: each block of rows gives its U entries and their
derivatives in the four log-parameters (d x = -C^{-1} (dC) x, with dC in
closed form), the elimination is differentiated in the U entries and the
nugget by torch.autograd, and the two meet in one contraction.
"""

from __future__ import annotations

import math

import torch

from . import factor

QUAD_NODES = 96           # trapezoid intervals of K_nu's integral
QUAD_TAIL = 60.0          # the integral stops where x (cosh t - 1) = this
ROW_BLOCK = 1024          # rows of U built at once


def _quad(x, orders, dnu=None):
    """[int_0^inf exp(-x cosh t) cosh(a t) dt for a in orders] (and with
    ``dnu`` also int t sinh(dnu t) exp(-x cosh t) dt, d/dnu K_nu at nu =
    dnu), by the trapezoidal rule on [0, T(x)] with QUAD_NODES intervals."""
    T = torch.acosh(1.0 + QUAD_TAIL / x)
    h = T / QUAD_NODES
    j = torch.arange(QUAD_NODES + 1, dtype=x.dtype, device=x.device)
    t = h[..., None] * j
    w = torch.ones_like(j)
    w[0] = 0.5
    f = torch.exp(-x[..., None] * torch.cosh(t)) * w
    out = [h * (f * torch.cosh(a * t)).sum(-1) for a in orders]
    if dnu is not None:
        out.append(h * (f * t * torch.sinh(dnu * t)).sum(-1))
    return out


def bessel_k(nu, x):
    """K_nu(x) for x > 0 (any shape)."""
    return _quad(x, [nu])[0]


def matern(s, nu, closed_half, derivs=False):
    """The Matern correlation g at s > 0, and with ``derivs`` also (dg/ds,
    dg/dnu); nu a float.  d/ds s^nu K_nu(s) = -s^nu K_{nu-1}(s)."""
    if closed_half:
        g = torch.exp(-s)
        return (g, -g, torch.zeros_like(g)) if derivs else g
    nut = torch.tensor(nu, dtype=s.dtype, device=s.device)
    c = torch.exp((1.0 - nut) * math.log(2.0) - torch.lgamma(nut)
                  + nut * torch.log(s))
    if not derivs:
        return c * _quad(s, [nut])[0]
    k, km1, dk = _quad(s, [nut, nut - 1.0], dnu=nut)
    g = c * k
    psi = float(torch.special.digamma(torch.tensor(nu, dtype=torch.float64)))
    return (g, -g * km1 / k,
            g * (torch.log(s) - math.log(2.0) - psi + dk / k))


def params(lg):
    """(sig2, range, nu, nugget) of the log-parameters, exponentiated as
    the harness hands them to the program (torch.exp of a float64 CPU
    tensor)."""
    return torch.exp(torch.as_tensor(lg, dtype=torch.float64)).tolist()


class Problem:
    """One configuration's data on ``device``: ordered locations, the
    conditioning sets and flags, the ordered observations and the levels
    of the factor."""

    def __init__(self, locsord, NN, cond, zord, levels, device):
        self.device = device
        self.locs = torch.as_tensor(locsord, dtype=torch.float64,
                                    device=device)
        self.NN = torch.as_tensor(NN, device=device).long()
        self.valid = self.NN >= 0
        self.cond = torch.as_tensor(cond, device=device) & self.valid
        self.resp = self.valid & ~self.cond
        self.resp[:, 0] = False
        self.zord = torch.as_tensor(zord, dtype=torch.float64, device=device)
        self.levels = factor.to_device(levels, device)
        self.n, self.K = self.NN.shape
        il, jl = torch.tril_indices(self.K, self.K, -1, device=device)
        self.il, self.jl = il, jl

    def columns(self, theta, rows, closed_half, derivs=False):
        """(U entries (R, K), rows whose covariance is not positive definite
        (R,)) of ``rows`` at theta = (sig2, range, nu, nugget) (floats), and
        with ``derivs`` their derivatives in the log-parameters (R, K, 4):
        d x = -C^{-1} (dC) x for x = C^{-1} e_0, and U = x / sqrt(x_0)."""
        sig2, rho, nu, nug = theta
        nn, v, resp = self.NN[rows], self.valid[rows], self.resp[rows]
        pts = self.locs[nn.clamp(min=0)]
        il, jl = self.il, self.jl
        d = torch.linalg.vector_norm(pts[:, il] - pts[:, jl], dim=-1)
        pv = v[:, il] & v[:, jl]
        s = torch.where(pv, d, 1.0) / rho
        R, K = nn.shape
        dev, dt = d.device, d.dtype
        ar = torch.arange(R, device=dev)[:, None]

        def sym(vals, diag):
            m = torch.zeros((R, K, K), dtype=dt, device=dev)
            m = m.index_put((ar, il[None, :], jl[None, :]),
                            torch.where(pv, vals, 0.0))
            return m + m.mT + torch.diag_embed(diag)

        out = matern(s, nu, closed_half, derivs)
        g = out[0] if derivs else out
        # (the diagonals from float64 tensors: torch.where of two Python
        # numbers is float32)
        vf, rf = v.to(dt), resp.to(dt)
        C = sym(sig2 * g, vf * (sig2 + rf * nug) + (1.0 - vf))
        L, info = torch.linalg.cholesky_ex(C)
        bad = info != 0
        L = torch.where(bad[:, None, None], torch.eye(K, dtype=dt,
                                                      device=dev), L)
        e0 = torch.zeros((R, K, 1), dtype=dt, device=dev)
        e0[:, 0] = 1.0
        x = torch.cholesky_solve(e0, L)
        col = torch.where(bad[:, None], 0.0, x[..., 0] / torch.sqrt(x[:, :1, 0]))
        if not derivs:
            return col, bad
        _, dgds, dgdnu = out
        zero = torch.zeros_like(v, dtype=dt)
        # theta_k dC/dtheta_k: the log-parameters' directions
        dC = torch.stack([
            sym(sig2 * g, vf * sig2),
            sym(sig2 * dgds * (-s), zero),
            sym(sig2 * nu * dgdnu, zero),
            sym(torch.zeros_like(g), rf * nug)], dim=1)
        dx = -torch.cholesky_solve((dC @ x[:, None]).squeeze(-1).mT, L)
        x0 = x[:, :1, 0]                                     # (R, 1)
        dcol = (dx / torch.sqrt(x0)[:, :, None]
                - x / (2.0 * x0[:, :, None] ** 1.5) * dx[:, :1, :])
        return col, bad, torch.where(bad[:, None, None], 0.0, dcol)

    def all_columns(self, theta, closed_half, derivs=False):
        outs = []
        with torch.no_grad():
            for r0 in range(0, self.n, ROW_BLOCK):
                rows = torch.arange(r0, min(self.n, r0 + ROW_BLOCK),
                                    device=self.device)
                outs.append(self.columns(theta, rows, closed_half, derivs))
        return [torch.cat(parts) for parts in zip(*outs)]

    def neg_loglik_of_columns(self, col, bad, nug):
        """-loglik from the U entries and the nugget."""
        z1 = (col * torch.where(self.resp, self.zord[self.NN.clamp(min=0)],
                                0.0)).sum(dim=1)
        logdet_w, aug = factor.eliminate(self.levels, col, z1, nug,
                                         self.zord, self.device)
        logu = torch.log(torch.where(bad, 1.0, col[:, 0])).sum()
        neg2 = (-2.0 * logu + self.n * torch.log(nug) + logdet_w + aug
                + self.n * math.log(2.0 * math.pi))
        return 0.5 * neg2

    def value(self, lg, closed_half=False):
        """(-loglik, rows dropped) at log-parameters ``lg`` (4,)."""
        theta = params(lg)
        with torch.no_grad():
            col, bad = self.all_columns(theta, closed_half)
            nug = torch.tensor(theta[3], dtype=torch.float64,
                               device=self.device)
            v = self.neg_loglik_of_columns(col, bad, nug)
        return float(v), int(bad.sum())

    def value_grad(self, lg, closed_half=False):
        """(-loglik, its gradient in lg (4,) as a list, rows dropped): the
        elimination differentiated in the U entries and the nugget by
        torch.autograd, the U entries' own derivatives in closed form."""
        theta = params(lg)
        col, bad, dcol = self.all_columns(theta, closed_half, derivs=True)
        col.requires_grad_()
        lnug = torch.tensor(lg[3], dtype=torch.float64, device=self.device,
                            requires_grad=True)
        # the nugget's value as the U entries took it, its derivative in lg
        nug = theta[3] * torch.exp(lnug - lnug.detach())
        v = self.neg_loglik_of_columns(col, bad, nug)
        gcol, gnug = torch.autograd.grad(v, (col, lnug))
        g = torch.einsum("ik,ikp->p", gcol, dcol)
        g[3] += gnug
        return float(v.detach()), g.tolist(), int(bad.sum())
