"""Hierarchical-Vecchia utilities (host-side NumPy/SciPy).

The port of the JAX package's ``hv.py``:

* ``get_mat_cov``: the (n_all, m+1) selected covariance matrix of
  Sigma[i, NN[i, j]], aligned with NNarray, from a dense matrix, a
  distance-based function or a (dense or sparse) factor (GPvecchia
  R/getMatCov.r); the likelihood, prediction and Vecchia-Laplace take it as
  ``covmodel`` (the selected covariance layout).
* ``create_L``: the sparse factor L of the covariance restricted to the
  Vecchia pattern by zero-fill incomplete Cholesky (GPvecchia
  R/createU.R:16-45); for hierarchical (ancestor-closed) patterns this is
  the exact hierarchical-Vecchia factor.
* ``ic0_csr``: that incomplete Cholesky on a lower CSR (GPvecchia
  src/ic0.cpp:43-64), vectorized by column levels: every entry of a
  column reads only columns of earlier levels, so a level is one batch of
  gathers and a sum per entry.  Each entry's sum runs over its products in
  the reference's order (ascending column), from 0: the values are the
  reference loop's bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .kernels.covariance import make_kernel_fn
from .plan import _solve_levels

__all__ = ["create_L", "get_mat_cov", "ic0_csr"]


def _pattern_csr(spec):
    """Lower CSR (ptrs, inds) over ordered points: row i = sorted
    conditioning set of i (ancestors + self)."""
    NN = spec.NNarray.astype(np.int64)
    valid = NN >= 0
    srt = np.sort(np.where(valid, NN, np.iinfo(np.int64).max), axis=1)
    ptrs = np.zeros(NN.shape[0] + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=ptrs[1:])
    return ptrs, srt[np.arange(NN.shape[1])[None, :]
                     < valid.sum(axis=1)[:, None]]


def _ragged_pairs(starts, counts):
    """(j, a): for each j, a runs from starts[j] over counts[j] values,
    ascending; j ascending."""
    total = int(counts.sum())
    first = np.zeros(counts.size, dtype=np.int64)
    np.cumsum(counts[:-1], out=first[1:])
    rep = np.repeat(np.arange(counts.size), counts)
    return rep, starts[rep] + (np.arange(total) - first[rep])


def ic0_csr(ptrs, inds, vals):
    """Up-looking incomplete Cholesky on a lower CSR (zero fill-in).

    Column indices ascend within each row with the diagonal last, as in
    the reference kernel (src/ic0.cpp:43-64).  Returns the factor's values
    on the pattern (a new array).
    """
    ptrs = np.asarray(ptrs, dtype=np.int64)
    inds = np.asarray(inds, dtype=np.int64)
    vals = np.array(vals, dtype=np.float64)
    n = ptrs.size - 1
    if n == 0:
        return vals
    row_of = np.repeat(np.arange(n), np.diff(ptrs))
    diag = ptrs[1:] - 1                       # diagonal slot of each row
    off = np.flatnonzero(inds != row_of)      # off-diagonal slots

    # products of L[i, c] (slot j): L[i, k] L[c, k] for k < c in both rows
    # i and c, k ascending; of L[i, i]: L[i, k]^2 over row i
    start = ptrs[row_of[off]]
    jj_i, aa = _ragged_pairs(start, off - start)
    jj = off[jj_i]
    keys = row_of * n + inds                  # ascending: CSR order
    q = inds[jj] * n + inds[aa]               # (row c, column k)
    pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    hit = keys[pos] == q
    tgt = np.concatenate([jj[hit], diag[row_of[off]]])
    pa = np.concatenate([aa[hit], off])
    pb = np.concatenate([pos[hit], off])

    # column levels: column c waits for the columns of row c's entries
    col_order = np.argsort(inds, kind="stable")
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(inds, minlength=n), out=colptr[1:])
    lev = _solve_levels(colptr, row_of[col_order], n, "fwd")

    # entries grouped by their column's level (and each entry's position
    # in its group); products grouped alike, each target's run in order
    ent_lev = lev[inds]
    ent = np.argsort(ent_lev, kind="stable")
    ent_bounds = np.searchsorted(ent_lev[ent], np.arange(lev.max() + 2))
    local = np.empty(inds.size, dtype=np.int64)
    local[ent] = np.arange(inds.size) - ent_bounds[ent_lev[ent]]
    prd_lev = ent_lev[tgt]
    prd = np.argsort(prd_lev, kind="stable")
    prd_bounds = np.searchsorted(prd_lev[prd], np.arange(lev.max() + 2))
    isdiag = inds == row_of
    for lv in range(1, int(lev.max()) + 1):
        e = ent[ent_bounds[lv]:ent_bounds[lv + 1]]
        p = prd[prd_bounds[lv]:prd_bounds[lv + 1]]
        dp = np.bincount(local[tgt[p]], weights=vals[pa[p]] * vals[pb[p]],
                         minlength=e.size)
        dg = isdiag[e]
        d = e[dg]
        vals[d] = np.sqrt(vals[d] - dp[dg])
        o = e[~dg]
        vals[o] = (vals[o] - dp[~dg]) / vals[diag[inds[o]]]
    return vals


def create_L(spec, covmodel, covparms=None):
    """Sparse lower-triangular factor L (rows back in original input order).

    covmodel: 'matern'/'esqe' (with covparms), a selected (n, m+1) matrix,
    or a distance-based callable of numpy arrays.
    """
    ptrs, inds = _pattern_csr(spec)
    locs = spec.locsord
    n = locs.shape[0]
    rows_rep = np.repeat(np.arange(n), np.diff(ptrs))
    d = np.sqrt(np.sum((locs[rows_rep] - locs[inds]) ** 2, axis=1))
    if isinstance(covmodel, str):
        kf = make_kernel_fn(covmodel)
        vals = kf(torch.as_tensor(d),
                  torch.as_tensor(np.asarray(covparms, np.float64))).numpy()
    elif callable(covmodel):
        vals = np.asarray(covmodel(d)).reshape(-1)
    elif isinstance(covmodel, np.ndarray) and covmodel.shape == (n, spec.m + 1):
        vals = _selected_to_pattern(spec, covmodel)
    else:
        raise ValueError("Argument covmodel has incorrect format")
    vals = ic0_csr(ptrs, inds, vals)
    L = sp.csr_matrix((vals, inds, ptrs), shape=(n, n))
    back = np.argsort(spec.ord, kind="stable")
    return L[back]


def _selected_to_pattern(spec, selmat):
    """(n, m+1) selected matrix (aligned with NNarray) -> pattern values:
    row i's first w_i entries (w_i its valid neighbors) in the order of
    its sorted conditioning set, as ``_pattern_csr`` lists it."""
    NN = spec.NNarray.astype(np.int64)
    valid = NN >= 0
    w = valid.sum(axis=1)
    # the valid neighbors moved to the front, in their order
    front = np.take_along_axis(NN, np.argsort(~valid, axis=1, kind="stable"),
                               axis=1)
    keep = np.arange(NN.shape[1])[None, :] < w[:, None]
    order = np.argsort(np.where(keep, front, np.iinfo(np.int64).max),
                       axis=1, kind="stable")
    return np.take_along_axis(np.asarray(selmat, np.float64), order,
                              axis=1)[keep]


def get_mat_cov(spec, source, factor: bool = False) -> np.ndarray:
    """Selected covariance (n, m+1) aligned with NNarray (self first; NaN pad).

    source: dense (n, n) covariance matrix; distance-based callable f(d);
    or (with factor=True) a dense or scipy-sparse factor F with FF^T = Sigma
    in *ordered* indexing.
    """
    NN = spec.NNarray
    n, mp1 = NN.shape
    valid = NN >= 0
    NNc = np.where(valid, NN, 0)
    out = np.full((n, mp1), np.nan)
    if factor:
        F = source
        if sp.issparse(F):
            F = F.tocsr()
            rows_i = np.repeat(np.arange(n), valid.sum(axis=1))
            rows_j = NN[valid]
            vals = np.asarray(F[rows_i].multiply(F[rows_j]).sum(axis=1)).ravel()
            out[valid] = vals
        else:
            F = np.asarray(source)
            prod = np.einsum("ik,ijk->ij", F, F[NNc])
            out = np.where(valid, prod, np.nan)
        return out
    if callable(source):
        d = np.sqrt(np.sum(
            (spec.locsord[:, None, :] - spec.locsord[NNc]) ** 2, axis=2))
        vals = np.asarray(source(d))
        return np.where(valid, vals, np.nan)
    Sigma = np.asarray(source)
    if Sigma.shape == (n, n):
        vals = Sigma[np.arange(n)[:, None], NNc]
        return np.where(valid, vals, np.nan)
    raise ValueError("unsupported getMatCov source")
