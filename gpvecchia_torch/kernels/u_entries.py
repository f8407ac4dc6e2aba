"""Batched U-column entries (the hot per-point kernel of the likelihood).

For every ordered point, x = C^{-1} e_self for the covariance C of [self +
conditioning set] (response-conditioned neighbors carry their nugget on the
diagonal), and the U column is col = x / sqrt(x_self): col[0] is the U
diagonal, col[j] the entry at neighbor j's row.  As in the JAX package's
``kernels/u_entries.py``:

* the built-in Matern builds, factors and solves in one kernel, H1
  (``matern_solve.matern_solve_e0``): at a closed-form smoothness (0.5,
  1.5, 2.5) always, at any other smoothness (log K_nu evaluated in the
  kernel) up to ``matern_solve.max_neighbors``;
* every other covariance (``esqe``, user callables, a full covariance
  matrix, and the general Matern above that bound) builds the packed
  covariance in torch (``build_cov_packed``) in row chunks and solves it
  with H8 (``matern_solve.solve_e0``).  Its backward recomputes each chunk with
  gradients (as ``jax.checkpoint`` does in the JAX package) and
  differentiates ``matern_solve.packed_solve_e0``, whose backward
  ``solve_e0_bwd`` (K2) gives the packed cotangent that torch autograd
  carries to covparms and the nuggets.

The normalization and the bad-row handling stay in torch.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .covariance import GENERAL, matern, nu_index, safe_dist
from .matern_solve import (matern_solve_e0, max_neighbors, packed_solve_e0,
                           solve_e0)

__all__ = ["u_entries", "build_cov_packed", "packed_pair_dist"]

# bytes of one row chunk's covariance temporaries: the general-smoothness
# build holds about a dozen (rows, P) tensors at once
_CHUNK_BYTES = 1 << 30
_CHUNK_TEMPS = 12


def _packed_index(F, device):
    """(iu, ju): the packed upper triangle's positions, row by row."""
    return torch.triu_indices(F, F, device=device)


def packed_pair_dist(locs, NN):
    """Packed pairwise distances (n, P) of each point's conditioning set."""
    iu, ju = _packed_index(NN.shape[1], locs.device)
    pts = locs[NN.long()]                                   # (n, F, d)
    diff = pts[:, iu, :] - pts[:, ju, :]
    return safe_dist((diff * diff).sum(-1))


def build_cov_packed(locs, NN, valid, cond, nug_point, kernel_fn, covparms,
                     covmat=None):
    """Packed upper-triangle covariance blocks, point-major: (n, P).

    Response-conditioned neighbors carry their nugget on the diagonal,
    invalid (padded) slots are identity-extended.  ``kernel_fn(dist,
    covparms)`` is evaluated on packed distances, or on location pairs when
    it carries ``takes_locs``; ``covmat``, a full (n_all, n_all) covariance
    over the ordered points, is gathered from instead of a kernel.
    """
    F = NN.shape[1]
    iu, ju = _packed_index(F, locs.device)
    NNl = NN.long()
    if covmat is not None:
        Cp = covmat[NNl[:, iu], NNl[:, ju]]
    elif getattr(kernel_fn, "takes_locs", False):
        pts = locs[NNl]
        Cp = kernel_fn(pts[:, iu, :], pts[:, ju, :], covparms)
    else:
        Cp = kernel_fn(packed_pair_dist(locs, NN), covparms)
    # the packed diagonal slots are the positions with iu == ju, at which
    # slot j has iu = j
    dmask = iu == ju
    nug_nb = torch.where(valid & ~cond, nug_point[NNl], 0.0)
    Cp = Cp + torch.where(dmask, nug_nb[:, iu], 0.0)
    vv = valid[:, iu] & valid[:, ju]
    return torch.where(vv, Cp, dmask.to(Cp.dtype))


def _row_chunks(n, F, dtype):
    P = F * (F + 1) // 2
    itemsize = torch.empty((), dtype=dtype).element_size()
    step = max(1, _CHUNK_BYTES // (_CHUNK_TEMPS * P * itemsize))
    return [slice(s, min(s + step, n)) for s in range(0, n, step)]


class _PackedSolve(torch.autograd.Function):
    """x = C^{-1} e0 (n, F) through ``build_cov_packed`` and H8, in row
    chunks; the backward recomputes each chunk with gradients, as
    ``jax.checkpoint`` does in the JAX package: it rebuilds the packed
    covariance, solves it by ``packed_solve_e0`` (H8, backward
    ``solve_e0_bwd``) and differentiates that.  No (n, P) tensor lives across
    chunks in either direction."""

    @staticmethod
    def forward(ctx, nug_point, covparms, geo, kernel_fn, covmat):
        locs, NN, valid, cond = geo
        chunks = _row_chunks(NN.shape[0], NN.shape[1], locs.dtype)
        x = torch.cat([solve_e0(build_cov_packed(
            locs, NN[sl], valid[sl], cond[sl], nug_point, kernel_fn,
            covparms, covmat)) for sl in chunks]) if chunks else \
            locs.new_zeros(0, NN.shape[1])
        ctx.geo, ctx.kernel_fn, ctx.covmat, ctx.chunks = (geo, kernel_fn,
                                                          covmat, chunks)
        ctx.save_for_backward(nug_point, covparms)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, xbar):
        nug_point, covparms = ctx.saved_tensors
        locs, NN, valid, cond = ctx.geo
        ng = nug_point.detach().requires_grad_(True)
        cp = covparms.detach().requires_grad_(True)
        dng = torch.zeros_like(nug_point)
        dcp = torch.zeros_like(covparms)
        for sl in ctx.chunks:
            with torch.enable_grad():
                Cp = build_cov_packed(locs, NN[sl], valid[sl], cond[sl], ng,
                                      ctx.kernel_fn, cp, ctx.covmat)
                if not Cp.requires_grad:
                    continue
                a, b = torch.autograd.grad(packed_solve_e0(Cp), (cp, ng),
                                           xbar[sl], allow_unused=True)
            if a is not None:
                dcp += a
            if b is not None:
                dng += b
        return dng, dcp, None, None, None


def u_entries(locs, NN, valid, cond, nug_point, covparms, kernel_fn=None,
              covmat=None):
    """(col, bad): U-column coefficients (n, m+1) aligned with NNarray (self
    first), and the per-row Cholesky-failure mask.

    ``kernel_fn`` is None for the built-in Matern, else an evaluator from
    ``covariance.make_kernel_fn``; ``covmat`` a full (n_all, n_all)
    covariance over the ordered points.  Differentiable in ``nug_point``
    and ``covparms`` (which may lie on another device and dtype: their
    gradients come back there)."""
    if not torch.is_tensor(covparms):
        covparms = torch.tensor(covparms, dtype=torch.float64)
    if covmat is None and kernel_fn in (None, matern):
        idx = nu_index(covparms[2])            # read on the host, once
        # by F alone: the fused kernels' shared-memory bound
        if idx != GENERAL or NN.shape[1] <= max_neighbors(locs.shape[1],
                                                          locs.dtype):
            x = matern_solve_e0(locs, NN, valid, valid & ~cond, nug_point,
                                covparms)
            return _postprocess(x, valid)

        def kernel_fn(dist, cp):
            return matern(dist, cp, GENERAL)
    cp = covparms.to(locs.device, locs.dtype)
    x = _PackedSolve.apply(nug_point, cp, (locs, NN, valid, cond), kernel_fn,
                           covmat)
    return _postprocess(x, valid)


def _postprocess(x, valid):
    """(col, bad): col = x / sqrt(x_self).  A non-SPD conditioning matrix
    poisons its row with NaN/Inf: the row becomes e0 (zero quadratic-form
    terms, zero logdet contribution) and the padded slots 0.  Callers
    exclude bad rows from W and report how many there were.

    A bad row is replaced in x, before the division, so that it is a
    constant of the result: its cotangent is exactly 0, and the backward
    kernels give a zero cotangent row a zero contribution.  The JAX package
    replaces it after the division, where 0 times the NaN row's derivative
    is NaN: one dropped row makes its whole covparms gradient NaN."""
    col = x / torch.sqrt(x[:, :1])
    bad = ~torch.all(torch.isfinite(col), dim=1)
    e0row = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    e0row[0] = 1.0
    x = torch.where(bad[:, None], e0row, x)
    return torch.where(valid, x / torch.sqrt(x[:, :1]), 0.0), bad
