"""Selected covariance matrices over a spec's conditioning sets (host-side).

A jax-free copy of the JAX package's ``hv.get_mat_cov`` (GPvecchia
R/getMatCov.r): the (n_all, m+1) matrix of Sigma[i, NN[i, j]], aligned
with NNarray, that the likelihood, prediction and Vecchia-Laplace take as
``covmodel`` (the selected covariance layout).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["get_mat_cov"]


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
