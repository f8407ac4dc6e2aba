"""The Vecchia specification of a configuration, worked out from its
locations alone (NumPy and SciPy's k-d tree; no code of the measured
package).

Three steps, each the plain statement of GPvecchia's rule:

* ``maxmin_order``: the exact maximum-minimum-distance ordering: the point
  nearest the centroid first, then always the point farthest from those
  already taken (ties: the larger index), then GPvecchia's head rotation
  (ranks 2..9 moved to the end, R/vecchia_specify.R:105-106).
* ``ordered_nn``: each ordered point's m nearest previously ordered points,
  nearest first, self in column 0, -1 padded.
* ``sgv_latent``: Sparse General Vecchia's choice of the neighbours
  conditioned on through their latent (R/whichCondOnLatent.R): the
  neighbour whose own latent set shares most of this row's points (the
  first in row order on a tie) lends its latent set.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch
from scipy.spatial import cKDTree


def maxmin_order(locs: np.ndarray) -> np.ndarray:
    """Exact maxmin ordering with GPvecchia's head rotation (int64)."""
    locs = np.ascontiguousarray(locs, dtype=np.float64)
    n = locs.shape[0]
    cen = locs.mean(axis=0)
    first = int(np.argmin(((locs - cen) ** 2).sum(axis=1)))
    d2 = ((locs - locs[first]) ** 2).sum(axis=1)
    tree = cKDTree(locs)
    order = np.empty(n, dtype=np.int64)
    order[0] = first
    d2[first] = -1.0
    # a max-heap of (d2, index) as (-d2, -index); an entry is stale once
    # the point's d2 has shrunk (every decrease pushes a fresh entry)
    heap = list(zip((-d2).tolist(), (-np.arange(n)).tolist()))
    heapq.heapify(heap)
    pos = 1
    while pos < n:
        negd, negi = heapq.heappop(heap)
        i = -negi
        if -negd != d2[i]:
            continue
        order[pos] = i
        pos += 1
        r2 = d2[i]
        d2[i] = -1.0
        near = np.asarray(tree.query_ball_point(
            locs[i], math.sqrt(r2) * (1.0 + 1e-12)), dtype=np.int64)
        dd = ((locs[near] - locs[i]) ** 2).sum(axis=1)
        upd = dd < d2[near]
        j = near[upd]
        dj = dd[upd]
        d2[j] = dj
        for item in zip((-dj).tolist(), (-j).tolist()):
            heapq.heappush(heap, item)
    cut = min(n, 9)
    return np.concatenate([order[:1], order[cut:], order[1:cut]])


def ordered_nn(locsord: np.ndarray, m: int) -> np.ndarray:
    """(n, m+1) int64: row i = [i, its m nearest among points 0..i-1,
    nearest first], -1 padded."""
    locsord = np.ascontiguousarray(locsord, dtype=np.float64)
    n = locsord.shape[0]
    m = min(m, n - 1)
    NN = np.full((n, m + 1), -1, dtype=np.int64)
    NN[:, 0] = np.arange(n)
    head = min(n, 8 * (m + 1))
    for i in range(1, head):
        d = ((locsord[:i] - locsord[i]) ** 2).sum(axis=1)
        take = np.argsort(d, kind="stable")[:m]
        NN[i, 1:1 + take.size] = take
    s = head
    while s < n:
        # a tree over [0, e) answers rows [s, e): at least half of its
        # points precede any of those rows
        e = min(n, 2 * s)
        tree = cKDTree(locsord[:e])
        todo = np.arange(s, e)
        k = min(e, 2 * m + 32)
        while todo.size:
            _, ii = tree.query(locsord[todo], k=k, workers=-1)
            prev = ii < todo[:, None]
            good = prev.sum(axis=1) >= m
            sel = np.argsort(~prev[good], axis=1, kind="stable")[:, :m]
            NN[todo[good], 1:] = np.take_along_axis(ii[good], sel, axis=1)
            todo = todo[~good]
            k = min(e, 2 * k)
        s = e
    return NN


def sgv_latent(NN: np.ndarray, device="cpu", chunk=4096) -> np.ndarray:
    """(n, m+1) bool: True where row i conditions on the latent of the
    point in that slot (always the row's own slot).

    A row depends only on the rows of its neighbours, so rows are taken in
    waves: a row's wave is one past the deepest wave among its neighbours,
    and every row of a wave is decided at once (torch on ``device``)."""
    NNt = torch.as_tensor(NN, device=device)
    n, K = NNt.shape
    valid = NNt >= 0
    nb = NNt[:, 1:].clamp(min=0)
    nbv = valid[:, 1:]
    wave = torch.zeros(n, dtype=torch.long, device=device)
    while True:
        w = torch.where(nbv, wave[nb] + 1, 0).amax(dim=1)
        if torch.equal(w, wave):
            break
        wave = w
    cond = torch.zeros((n, K), dtype=torch.bool, device=device)
    cond[:, 0] = valid[:, 0]
    order = torch.argsort(wave, stable=True)
    counts = torch.bincount(wave).tolist()
    start = counts[0]
    for c in counts[1:]:
        for s0 in range(start, start + c, chunk):
            k = order[s0:min(start + c, s0 + chunk)]
            row, rv = NNt[k], valid[k]                       # (R, K)
            cand, cv = nb[k], nbv[k]                         # (R, K-1)
            cset = torch.where(cond[cand], NNt[cand], -2)    # (R, K-1, K)
            hit = (cset[:, :, :, None] == row[:, None, None, :]) & rv[
                :, None, None, :]
            score = torch.where(cv, hit.any(dim=2).sum(dim=2), 0)
            best = score.argmax(dim=1)
            ok = score.amax(dim=1) > 0
            lat = cset[torch.arange(k.numel(), device=device), best]
            take = (row[:, :, None] == lat[:, None, :]).any(dim=2)
            take &= ok[:, None] & rv
            take[:, 0] = True
            cond[k] = take & rv
        start += c
    return cond.cpu().numpy()


def sgv_spec(locs: np.ndarray, m: int, device="cpu"):
    """(ord, locsord, NN, cond) of ``vecchia_specify(locs, m,
    cond_yz="SGV")`` without prediction points."""
    ordv = maxmin_order(locs)
    locsord = np.ascontiguousarray(locs[ordv])
    NN = ordered_nn(locsord, m)
    return ordv, locsord, NN, sgv_latent(NN, device)
