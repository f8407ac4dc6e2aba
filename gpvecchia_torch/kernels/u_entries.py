"""Batched U-column entries (the hot per-point kernel of the likelihood).

For every ordered point, x = C^{-1} e_self for the covariance C of [self +
conditioning set] (response-conditioned neighbors carry their nugget on the
diagonal), and the U column is col = x / sqrt(x_self): col[0] is the U
diagonal, col[j] the entry at neighbor j's row.  The factor-and-solve is
H1 (``matern_solve.matern_solve_e0``); the normalization and the bad-row
handling stay in torch, as in the JAX package's ``kernels/u_entries.py``.
"""

from __future__ import annotations

import torch

from .matern_solve import matern_solve_e0

__all__ = ["u_entries"]


def _postprocess(col, valid):
    """A non-SPD conditioning matrix poisons its row with NaN/Inf: replace
    the row with e0 (zero quadratic-form terms, zero logdet contribution)
    and zero the padded slots.  Returns (col, bad); callers exclude bad rows
    from W and report how many there were."""
    bad = ~torch.all(torch.isfinite(col), dim=1)
    e0row = torch.zeros(col.shape[1], dtype=col.dtype, device=col.device)
    e0row[0] = 1.0
    col = torch.where(bad[:, None], e0row, col)
    return torch.where(valid, col, 0.0), bad


def u_entries(locs, NN, valid, cond, nug_point, covparms):
    """(col, bad): U-column coefficients (n, m+1) aligned with NNarray (self
    first), and the per-row Cholesky-failure mask."""
    x = matern_solve_e0(locs, NN, valid, valid & ~cond, nug_point, covparms)
    col = x / torch.sqrt(x[:, :1])
    return _postprocess(col, valid)
