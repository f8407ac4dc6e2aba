"""User-facing incomplete Cholesky (zero fill-in) on a sparsity mask.

The port of the JAX package's ``linalg/ichol.py``, the reference's exported
``ichol(M, S)`` (GPvecchia R/ichol.R:16-59): triangularize the inputs,
restrict M to the mask's lower-triangular pattern, and run IC0 on the CSR
slots (``hv.ic0_csr``, GPvecchia src/ic0.cpp:43-64).  Host-side NumPy.
"""

from __future__ import annotations

import numpy as np

from ..hv import ic0_csr

__all__ = ["ichol"]


def ichol(M, S=None):
    """Incomplete Cholesky factor of dense SPD ``M`` on the pattern of ``S``.

    M: (n, n) dense symmetric positive-definite matrix (upper part ignored).
    S: optional (n, n) mask (nonzero = keep); defaults to the pattern of M.
    Returns the dense lower-triangular IC0 factor L with L L^T ~= M on the
    retained pattern.  With a full mask this is the exact Cholesky factor.
    """
    M = np.asarray(M, dtype=np.float64)
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError("M must be square")
    if S is None:
        pat = M != 0.0
    else:
        S = np.asarray(S)
        if S.shape != (n, n):
            raise ValueError("S must have the same shape as M")
        pat = S != 0
    pat = np.tril(pat | pat.T)
    np.fill_diagonal(pat, True)

    # lower CSR with ascending columns, diagonal last in each row
    rows, cols = np.nonzero(pat)
    ptrs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptrs[1:])
    vals = ic0_csr(ptrs, cols, M[rows, cols])
    L = np.zeros((n, n))
    L[rows, cols] = vals
    return L
