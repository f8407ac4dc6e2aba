"""Host-side symbolic analysis (runs once per spec; NumPy).

A jax-free copy of the JAX package's ``symbolic.py``: the lower pattern of
W = U_y U_y^T + D in reversed ordering as a CSR, its symbolic Cholesky fill
(the native ``csrc.host.symbolic_chol`` with Liu's row-pattern algorithm
as the NumPy fallback), and level groupings of columns.  The per-entry V
machinery of ``plan.ensure_v`` builds its factor and solve schedules from
these patterns (GPvecchia R/U_sparsity.R and the sparse symbolics it
leaves to the R Matrix package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .csrc import host

__all__ = ["LowerCSR", "csr_from_coo_lower", "symbolic_cholesky",
           "build_levels", "cols_to_lower_csr", "col_levels_backward"]


@dataclasses.dataclass
class LowerCSR:
    """Lower-triangular symmetric pattern, CSR by rows, sorted columns."""
    n: int
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (nnz,) int64, col indices (<= row), ascending per row

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    _keys: np.ndarray | None = None

    def flat_keys(self) -> np.ndarray:
        """int64 keys row*n + col for vectorized slot lookup (cached)."""
        if self._keys is None:
            rows = np.repeat(np.arange(self.n, dtype=np.int64),
                             np.diff(self.indptr))
            self._keys = rows * self.n + self.indices
        return self._keys

    def lookup(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Slot of each (row, col) in the flat value array; -1 if absent."""
        keys = self.flat_keys()
        q = rows.astype(np.int64) * self.n + cols.astype(np.int64)
        pos = np.searchsorted(keys, q)
        pos_c = np.clip(pos, 0, keys.size - 1)
        ok = keys[pos_c] == q
        return np.where(ok, pos_c, -1).astype(np.int64)


def csr_from_coo_lower(n: int, rows: np.ndarray, cols: np.ndarray) -> LowerCSR:
    """Build a deduplicated lower CSR from (row >= col) COO pairs."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keys = np.unique(rows * n + cols)
    r = keys // n
    c = keys % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    np.cumsum(indptr, out=indptr)
    return LowerCSR(n=n, indptr=indptr, indices=c)


def symbolic_cholesky(A: LowerCSR):
    """Symbolic Cholesky of a symmetric matrix given by its lower pattern.

    Returns (cols, parent, row_level) where
      cols[j]  = np.ndarray of rows i >= j with L[i, j] != 0 (ascending, j first),
      parent   = elimination-tree parent (or -1),
      row_level[i] = forward-dependency level of row i (1 + max over the
                     levels of the off-diagonal columns in row i of L).

    Classic quasilinear row-pattern algorithm (Liu): the pattern of row i is
    the union of etree paths from each A-nonzero column of row i up to i.
    """
    n = A.n
    native = host.symbolic_chol(A.indptr, A.indices, n)
    if native is not None:
        return native

    parent = np.full(n, -1, dtype=np.int64)
    flag = np.full(n, -1, dtype=np.int64)
    row_level = np.zeros(n, dtype=np.int64)
    cols: list[list[int]] = [[j] for j in range(n)]

    indptr, indices = A.indptr, A.indices
    for i in range(n):
        flag[i] = i
        lev = 0
        for idx in range(indptr[i], indptr[i + 1]):
            j = indices[idx]
            if j == i:
                continue
            while flag[j] != i:
                flag[j] = i
                cols[j].append(i)       # L[i, j] != 0
                if row_level[j] + 1 > lev:
                    lev = row_level[j] + 1
                if parent[j] == -1:
                    parent[j] = i
                j = parent[j]
        row_level[i] = lev

    col_arrays = [np.asarray(c, dtype=np.int64) for c in cols]
    return col_arrays, parent, row_level


def build_levels(values: np.ndarray) -> list[np.ndarray]:
    """Group indices by level value (ascending); returns list of index arrays."""
    order = np.argsort(values, kind="stable")
    sorted_vals = values[order]
    boundaries = np.flatnonzero(np.diff(sorted_vals)) + 1
    return list(np.split(order, boundaries))


def cols_to_lower_csr(col_arrays: list[np.ndarray], n: int) -> LowerCSR:
    """Column patterns (rows >= j) -> lower CSR by rows (cols <= i)."""
    counts = np.array([c.size for c in col_arrays], dtype=np.int64)
    rows = np.concatenate(col_arrays) if col_arrays else np.empty(0, np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), counts)
    return csr_from_coo_lower(n, rows, cols)


def col_levels_backward(col_arrays: list[np.ndarray]) -> np.ndarray:
    """Backward-solve level of each column: 1 + max level of rows in its pattern.

    Longest path computed by vectorized wave iteration (converges in
    #levels sweeps): level[j] = 1 + max(level[rows of col j]).
    """
    n = len(col_arrays)
    counts = np.array([c.size for c in col_arrays], dtype=np.int64)
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=colptr[1:])
    rows = (np.concatenate(col_arrays) if col_arrays
            else np.empty(0, np.int64))
    level = np.ones(n, dtype=np.int64)
    has_anc = counts > 1
    while True:
        gathered = level[rows]
        # drop the diagonal (first entry of each column)
        gathered[colptr[:-1]] = 0
        segmax = (np.maximum.reduceat(gathered, colptr[:-1]) if rows.size
                  else np.zeros(n, np.int64))
        new = np.where(has_anc, segmax + 1, 1)
        if np.array_equal(new, level):
            return level
        level = new
