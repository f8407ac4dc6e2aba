"""Point orderings for Vecchia approximations (host-side, NumPy).

Design note: orderings are inherently sequential greedy algorithms
and run ONCE per geometry, so they live on the host.  The exact maximum-minimum
distance ordering is implemented with a lazy max-heap + periodic cKDTree
rebuilds, which is exact and quasilinear in practice.

Reference parity targets (behavior, not code):
  - order_maxmin_exact       ~ GPvecchia R/ordering_functions.R:147-150
                               (engine GPvecchia src/MaxMin.cpp:661-738)
  - order_coordinate         ~ GPvecchia R/ordering_functions.R:126-128
  - order_dist_to_point      ~ GPvecchia R/ordering_functions.R:21-47
  - order_middleout          ~ GPvecchia R/ordering_functions.R:64-81
  - order_outsidein          ~ GPvecchia R/ordering_functions.R:98-102
  - order_maxmin_exact_obs_pred ~ GPvecchia R/ordering_functions.R:174-218

All functions take an (n, d) float array and return an int64 permutation of
0..n-1 (0-based, unlike the R reference's 1-based indices).
"""

from __future__ import annotations

import heapq

import numpy as np
from scipy.spatial import cKDTree

__all__ = [
    "order_maxmin_exact",
    "order_maxmin_exact_obs_pred",
    "order_coordinate",
    "order_dist_to_point",
    "order_middleout",
    "order_outsidein",
    "lonlat_to_xyz",
]


def lonlat_to_xyz(locs: np.ndarray) -> np.ndarray:
    """Convert (lon, lat) degrees to points on the unit sphere in R^3.

    Same convention as the reference (GPvecchia R/ordering_functions.R:23-32).
    """
    lon = np.asarray(locs[:, 0], dtype=np.float64)
    lat = np.asarray(locs[:, 1], dtype=np.float64)
    lonrad = lon * 2.0 * np.pi / 360.0
    latrad = (lat + 90.0) * 2.0 * np.pi / 360.0
    x = np.sin(latrad) * np.cos(lonrad)
    y = np.sin(latrad) * np.sin(lonrad)
    z = np.cos(latrad)
    return np.stack([x, y, z], axis=1)


def order_dist_to_point(locs: np.ndarray, loc0, lonlat: bool = False) -> np.ndarray:
    """Order locations by increasing distance to a reference point."""
    locs = np.asarray(locs, dtype=np.float64)
    if lonlat:
        locs = lonlat_to_xyz(locs)
    loc0 = np.asarray(loc0, dtype=np.float64).reshape(1, -1)
    if loc0.shape[1] != locs.shape[1]:
        raise ValueError("loc0 dimension does not match locs")
    d = np.einsum("ij,ij->i", locs - loc0, locs - loc0)
    return np.argsort(d, kind="stable")


def order_middleout(locs: np.ndarray, lonlat: bool = False) -> np.ndarray:
    """Order by increasing distance to the centroid."""
    locs = np.asarray(locs, dtype=np.float64)
    if lonlat:
        locs = lonlat_to_xyz(locs)
    return order_dist_to_point(locs, locs.mean(axis=0))


def order_outsidein(locs: np.ndarray, lonlat: bool = False) -> np.ndarray:
    """Reverse middle-out ordering."""
    return order_middleout(locs, lonlat)[::-1].copy()


def order_coordinate(locs: np.ndarray, coordinate=None) -> np.ndarray:
    """Order by the sum of the selected coordinates (all by default)."""
    locs = np.asarray(locs, dtype=np.float64)
    if coordinate is None:
        key = locs.sum(axis=1)
    else:
        coordinate = np.atleast_1d(np.asarray(coordinate, dtype=np.int64))
        key = locs[:, coordinate].sum(axis=1)
    return np.argsort(key, kind="stable")


def order_maxmin_exact(locs: np.ndarray, first: int | None = None) -> np.ndarray:
    """Exact maximum-minimum-distance ordering.

    Greedy: the first point is the one closest to the centroid (matching the
    reference engine's start rule, GPvecchia src/MaxMin.cpp:676-707); each
    subsequent point maximizes its minimum distance to the already-selected set.

    Exactness via the lazy-heap argument: cached distances only shrink as the
    selected set grows, so when a popped candidate's *recomputed* distance still
    beats the next (stale, hence over-estimated) heap key, it is the true argmax.

    Nearest-selected-point queries use a cKDTree over a snapshot of the selected
    set, rebuilt geometrically, plus a brute-force check against the points
    selected since the snapshot.
    """
    locs = np.ascontiguousarray(np.asarray(locs, dtype=np.float64))
    n = locs.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)

    if first is None:
        from ..csrc import host as csrc
        native = csrc.maxmin_exact(locs)
        if native is not None:
            return native

        centroid = locs.mean(axis=0)
        diffs = locs - centroid
        first = int(np.argmin(np.einsum("ij,ij->i", diffs, diffs)))

    order = np.empty(n, dtype=np.int64)
    order[0] = first
    selected = np.zeros(n, dtype=bool)
    selected[first] = True

    # initial distances to the first point
    diffs = locs - locs[first]
    d2 = np.einsum("ij,ij->i", diffs, diffs)
    d2[first] = -np.inf

    # max-heap over (-d2, idx); entries may be stale (d2 can only have shrunk)
    heap = [(-d2[i], i) for i in range(n) if i != first]
    heapq.heapify(heap)

    tree = cKDTree(locs[first][None, :])
    tree_size = 1  # number of selected points included in `tree`
    recent: list[int] = []  # selected points not yet in the tree

    for pos in range(1, n):
        while True:
            negd, i = heapq.heappop(heap)
            if selected[i]:
                continue
            cached = -negd
            # recompute the true current min-distance for i
            true_d2 = cached
            if recent:
                rec = np.asarray(recent, dtype=np.int64)
                dd = locs[rec] - locs[i]
                true_d2 = min(true_d2, float(np.min(np.einsum("ij,ij->i", dd, dd))))
            # tree part is already reflected in `cached` only if cached was
            # computed after the last tree rebuild -- we cannot know, so query.
            dt, _ = tree.query(locs[i], k=1)
            true_d2 = min(true_d2, float(dt) ** 2)
            next_best = -heap[0][0] if heap else -np.inf
            if true_d2 >= next_best:
                order[pos] = i
                selected[i] = True
                recent.append(i)
                break
            heapq.heappush(heap, (-true_d2, i))

        # geometric tree rebuilds keep amortized cost quasilinear
        if len(recent) * 4 >= tree_size or len(recent) >= 512:
            tree_size += len(recent)
            tree = cKDTree(locs[order[:pos + 1]])
            recent = []

    return order


def order_maxmin_exact_obs_pred(locs: np.ndarray, locs_pred: np.ndarray):
    """Maxmin ordering of observed and prediction locations.

    Observed and prediction sets are maxmin-ordered separately; prediction
    points that are near-neighbors of previously-ordered points are then pushed
    to the end with a kNN sweep, mirroring the reference behavior
    (GPvecchia R/ordering_functions.R:174-218).

    Returns (ord_obs, ord_pred), both 0-based into their own sets.
    """
    locs = np.asarray(locs, dtype=np.float64)
    locs_pred = np.asarray(locs_pred, dtype=np.float64)
    n = locs.shape[0]
    n_pred = locs_pred.shape[0]

    ord_obs = order_maxmin_exact(locs)
    ord_pred = order_maxmin_exact(locs_pred)

    locs_all = np.vstack([locs, locs_pred])
    m = int(min(round(np.sqrt(n)), 200))
    m = max(m, 1)

    # kNN over the combined set (neighbors exclude self)
    k = min(m + 1, n + n_pred)
    _, nn = cKDTree(locs_all).query(locs_all, k=k)
    if nn.ndim == 1:
        nn = nn[:, None]
    # drop self-column
    self_col = nn == np.arange(n + n_pred)[:, None]
    NN = np.empty((n + n_pred, k - 1), dtype=np.int64)
    for i in range(n + n_pred):
        row = nn[i][~self_col[i]][: k - 1]
        if row.size < k - 1:
            row = np.pad(row, (0, k - 1 - row.size), constant_values=row[-1] if row.size else i)
        NN[i] = row
    mm = NN.shape[1]

    total = n + n_pred
    # list emulates R's auto-growing vector (a pred point may be moved to the
    # end more than once while it still has previously-ordered neighbors)
    index_in_position = list(ord_obs) + list(n + ord_pred)
    position_of_index = np.empty(total, dtype=np.int64)
    position_of_index[np.asarray(index_in_position)] = np.arange(total)

    nmoved = 0
    for j in range(n, n + 2 * n_pred):
        if j >= len(index_in_position):
            break
        idx = index_in_position[j]
        if idx < 0:
            continue
        nneigh = int(round(min(mm, 1.0 * total / (j - nmoved + 1))))
        nneigh = max(nneigh, 1)
        neighbors = NN[idx, :nneigh]
        if np.min(position_of_index[neighbors]) < j:
            nmoved += 1
            position_of_index[idx] = len(index_in_position)
            index_in_position.append(idx)
            index_in_position[j] = -1

    index_in_position = np.asarray(index_in_position, dtype=np.int64)

    kept = index_in_position[index_in_position >= 0]
    ord_pred_final = kept[n:] - n
    return ord_obs, ord_pred_final
