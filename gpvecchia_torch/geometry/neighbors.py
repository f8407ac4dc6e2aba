"""Ordered nearest-neighbor conditioning sets (host-side, NumPy/cKDTree).

For ordered locations, row i of the returned NNarray is
[i, j_1, ..., j_m] where j_k < i are the m nearest previously-ordered
neighbors of point i (fewer for the first rows; padded with -1).

Reference parity targets (behavior, not code):
  - GpGp::find_ordered_nn used at GPvecchia R/vecchia_specify.R:159
  - findOrderedNN_kdtree2 at GPvecchia R/NN_kdtree.R:36-68 (1-D case)

Design note: this runs once per geometry on the host.  The chunked
algorithm is exact: for a chunk [a, b), neighbors among [0, a) come from a
cKDTree query (k = m), and neighbors inside the chunk [a, i) come from a
brute-force pass; the two candidate sets are merged by distance.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["find_ordered_nn", "knn_indices"]


def knn_indices(locs: np.ndarray, k: int, query: np.ndarray | None = None) -> np.ndarray:
    """Plain k-nearest-neighbor indices (excluding self when query is locs)."""
    locs = np.asarray(locs, dtype=np.float64)
    tree = cKDTree(locs)
    if query is None:
        _, nn = tree.query(locs, k=min(k + 1, locs.shape[0]))
        nn = np.atleast_2d(nn)
        out = np.empty((locs.shape[0], min(k, locs.shape[0] - 1)), dtype=np.int64)
        for i in range(locs.shape[0]):
            row = nn[i][nn[i] != i]
            out[i] = row[: out.shape[1]]
        return out
    query = np.asarray(query, dtype=np.float64)
    _, nn = tree.query(query, k=min(k, locs.shape[0]))
    return np.atleast_2d(nn)


def find_ordered_nn(locsord: np.ndarray, m: int, chunk: int = 4096) -> np.ndarray:
    """Exact m nearest previously-ordered neighbors for each ordered point.

    Returns an (n, m+1) int64 array; row i = [i, nearest previous, ...],
    ordered by increasing distance, padded with -1 where i < m.
    """
    locsord = np.ascontiguousarray(np.asarray(locsord, dtype=np.float64))
    n, _ = locsord.shape
    m = int(min(m, n - 1))
    NN = np.full((n, m + 1), -1, dtype=np.int64)
    NN[:, 0] = np.arange(n)
    if m == 0 or n <= 1:
        return NN

    if chunk == 4096:  # default path: try the native kernel
        from ..csrc import host as csrc
        native = csrc.ordered_nn(locsord, m)
        if native is not None:
            return native

    # head: brute force over the first block (vectorized top-m per row)
    head = min(n, max(min(chunk, 2048), m + 1))
    d_head = _pairwise_sq(locsord[:head], locsord[:head])
    iu = np.triu_indices(head, 0)
    d_head[iu] = np.inf  # only previous points allowed
    _fill_topm(NN, d_head, np.arange(head), row_offset=0, m=m)

    # tail: chunked tree queries against [0, a) + brute force inside the chunk
    a = head
    while a < n:
        b = min(n, a + chunk)
        c = b - a
        tree = cKDTree(locsord[:a])
        q = locsord[a:b]
        k = min(m, a)
        dt, it = tree.query(q, k=k)
        dt = dt.reshape(c, k)
        it = it.reshape(c, k)
        # merge tree candidates with in-chunk previous points, vectorized
        d_in = _pairwise_sq(q, q)
        mask = np.triu_indices(c, 0)
        d_in[mask] = np.inf
        cand_d = np.concatenate([dt ** 2, d_in], axis=1)   # (c, k + c)
        cand_idx = np.concatenate(
            [it, np.broadcast_to(np.arange(a, b), (c, c))], axis=1)
        take = min(m, cand_d.shape[1])
        part = np.argpartition(cand_d, take - 1, axis=1)[:, :take]
        rows = np.arange(c)[:, None]
        sub_d = cand_d[rows, part]
        order = np.argsort(sub_d, axis=1, kind="stable")
        sel = part[rows, order]
        sel_d = cand_d[rows, sel]
        sel_i = cand_idx[rows, sel]
        valid_sel = np.isfinite(sel_d)
        NN[a:b, 1:1 + take] = np.where(valid_sel, sel_i, -1)
        a = b

    return NN


def _fill_topm(NN, d, idx_map, row_offset, m):
    """Vectorized top-m (by distance) per row of a masked distance matrix."""
    nrow = d.shape[0]
    take = min(m, d.shape[1])
    if take == 0:
        return
    part = np.argpartition(d, min(take - 1, d.shape[1] - 1), axis=1)[:, :take]
    rows = np.arange(nrow)[:, None]
    sub = d[rows, part]
    order = np.argsort(sub, axis=1, kind="stable")
    sel = part[rows, order]
    sel_d = d[rows, sel]
    out = np.where(np.isfinite(sel_d), idx_map[sel], -1)
    NN[row_offset:row_offset + nrow, 1:1 + take] = out


def _pairwise_sq(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x[:, None, :] - y[None, :, :]
    return np.einsum("ijk,ijk->ij", d, d)
