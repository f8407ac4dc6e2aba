"""Sparse-general-Vecchia latent/response conditioning selection (host-side).

For each ordered point, choose which neighbors to condition on as latent (y)
versus response (z): find the neighbor whose own latent-conditioned set
overlaps the point's neighbor set the most, and condition on latent exactly
for that neighbor's latent set.  Prediction points always condition on latent.

Reference parity target (behavior, not code):
  whichCondOnLatent ~ GPvecchia R/whichCondOnLatent.R:2-27

The greedy recursion is sequential over rows and runs once per geometry, so it
stays on the host.  Row work is vectorized with NumPy broadcasting.
"""

from __future__ import annotations

import numpy as np

__all__ = ["which_cond_on_latent"]


def which_cond_on_latent(NNarray: np.ndarray, firstind_pred: int | None = None) -> np.ndarray:
    """Boolean (n, m+1) mask aligned with NNarray: True = condition on latent.

    ``NNarray`` is (n, m+1) int, self first, -1 padded, 0-based ordered indices.
    ``firstind_pred`` is the first ordered index that is a prediction point
    (default: n, i.e. no prediction points).
    """
    NN = np.asarray(NNarray, dtype=np.int64)
    n, mp1 = NN.shape
    if firstind_pred is None:
        firstind_pred = n

    from ..csrc import host as csrc
    native = csrc.sgv_select(NN, int(firstind_pred))
    if native is not None:
        return native

    cond = np.zeros((n, mp1), dtype=bool)
    valid = NN >= 0
    cond[0, 0] = True

    for k in range(1, n):
        row = NN[k]
        vrow = valid[k]
        # candidate latent neighbors: previous points, not prediction points
        cand = vrow.copy()
        cand[0] = False
        cand &= (row < firstind_pred) & (row >= 0)
        best_l = -1
        if np.any(cand):
            ls = row[cand]
            # latent sets of each candidate: NN[l] where cond[l]
            sets = np.where(cond[ls], NN[ls], -2)      # (ncand, m+1)
            # overlap counts with this row's neighbor set
            hits = (sets[:, None, :] == row[None, :, None]) & vrow[None, :, None]
            scores = hits.any(axis=2).sum(axis=1)       # (ncand,)
            if scores.max() > 0:
                # first candidate (in row order) achieving the max, matching
                # the reference's `which(...)[1]` tie-break
                best_l = int(ls[np.argmax(scores)])
        if best_l >= 0:
            lat_set = NN[best_l][cond[best_l]]
            cond[k] = np.isin(row, lat_set)
        else:
            cond[k] = False
        cond[k] |= (row >= firstind_pred)
        cond[k, 0] = True
        cond[k] &= vrow
    return cond
