"""Vecchia approximation specification (parameter-free, host-side).

``vecchia_specify`` mirrors the reference's option surface and defaulting
logic (GPvecchia R/vecchia_specify.R:29-240) but produces a typed,
padded-dense ``VecchiaSpec`` instead of CSR index vectors: the sparse U factor
is never materialized — its latent part is exactly an (n_all, m+1) dense array
of per-column coefficients plus the NNarray index array, which is what the
device compute path consumes (see SURVEY.md section 0).

Representation
--------------
Ordered points k = 0..n_all-1.  Each point may carry a latent variable
(``has_latent``) and/or an observation (``has_obs``); in the reference each
point is latent + optionally observed, except in the response-first 'zy'
family where pure-response rows exist (the reference emulates those with
dummy-row doubling and sparse-matrix surgery, R/vecchia_specify.R:191-224 and
R/createU.R:166-171 — here they are first-class).

``NNarray`` is (n_all, m+1) int32, 0-based, self first, -1 padded.
``cond_latent`` aligned with NNarray: True = condition on that neighbor's
latent y, False = on its observed z.  Self is always latent.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from .geometry.mra import find_ordered_nn_mra
from .geometry.neighbors import find_ordered_nn, knn_indices
from .geometry.ordering import (order_coordinate, order_maxmin_exact,
                                order_maxmin_exact_obs_pred, order_outsidein)
from .geometry.sgv import which_cond_on_latent

__all__ = ["VecchiaSpec", "vecchia_specify"]


@dataclasses.dataclass
class VecchiaSpec:
    """Parameter-free specification of a general Vecchia approximation."""

    locsord: np.ndarray        # (n_all, d) ordered locations (may repeat for zy)
    NNarray: np.ndarray        # (n_all, m+1) int32, self first, -1 padded
    cond_latent: np.ndarray    # (n_all, m+1) bool
    has_latent: np.ndarray     # (n_all,) bool
    has_obs: np.ndarray        # (n_all,) bool
    ord: np.ndarray            # (n_locs,) ordered seq -> stacked [locs; locs_pred]
    ord_z: np.ndarray          # (n_obs,) z ordering: zord = z[ord_z]
    ordering_pred: str         # 'obspred' | 'general'
    cond_yz: str               # 'y'|'z'|'SGV'|'SGVT'|'zy'|'m0'
    conditioning: str          # 'NN' | 'mra' | 'firstm'
    ic0: bool = False
    n_obs: int = 0             # number of observed locations
    n_pred: int = 0            # number of prediction locations
    mra_eff_m: int | None = None
    # zero-nugget variant marker: points whose observation is EXACT (their
    # latent is known, so they behave as response-type columns; reference
    # handles this by row deletion + permutation, R/createU.R:83-86,173-193)
    known_pts: np.ndarray | None = None
    # (n_obs,) ordered-position mask of exact observations; when None the
    # plan derives it as known_pts & has_obs (correct for the standard
    # layout, where the known point carries the observation itself — the zy
    # family keeps the observation on the response point and marks the
    # latent twin known, so it must set this explicitly)
    zero_obs_mask: np.ndarray | None = None

    # ---- derived, cached ----
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_all(self) -> int:
        return self.locsord.shape[0]

    @property
    def m(self) -> int:
        return self.NNarray.shape[1] - 1

    @property
    def n_latent(self) -> int:
        return int(self.has_latent.sum())

    @property
    def obs_pos(self) -> np.ndarray:
        """(n_all,) position among observed points; -1 if unobserved."""
        if "obs_pos" not in self._cache:
            p = np.full(self.n_all, -1, dtype=np.int64)
            p[self.has_obs] = np.arange(int(self.has_obs.sum()))
            self._cache["obs_pos"] = p
        return self._cache["obs_pos"]

    @property
    def latent_rank(self) -> np.ndarray:
        """(n_all,) rank among latent points; -1 if none."""
        if "latent_rank" not in self._cache:
            p = np.full(self.n_all, -1, dtype=np.int64)
            p[self.has_latent] = np.arange(self.n_latent)
            self._cache["latent_rank"] = p
        return self._cache["latent_rank"]

    @property
    def latent_point(self) -> np.ndarray:
        """(n_latent,) ordered point index of each latent variable."""
        if "latent_point" not in self._cache:
            self._cache["latent_point"] = np.flatnonzero(self.has_latent)
        return self._cache["latent_point"]

    def cached(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]


def vecchia_specify(locs, m=-1, ordering=None, cond_yz=None, locs_pred=None,
                    ordering_pred=None, pred_cond="general", conditioning="NN",
                    mra_options=None, ic0=False, verbose=False) -> VecchiaSpec:
    """Specify a general Vecchia approximation (runs once per geometry).

    Option semantics mirror the reference's vecchia_specify
    (GPvecchia R/vecchia_specify.R), including defaulting rules:
    ordering 'coord' in 1-D else 'maxmin'; cond_yz 'y' for mra, 'SGV'
    without predictions or in 1-D, 'zy' with predictions; the maxmin head
    rotation; and the obspred prediction ordering.  'firstm' is MRA with
    r = (m, 1); MRA forces the maxmin ordering.
    """
    locs = np.atleast_2d(np.asarray(locs, dtype=np.float64))
    n, d = locs.shape
    if m is None:
        m = -1
    if m == -1 and not (conditioning == "mra" and mra_options):
        raise ValueError("neither m nor mra parameters defined")

    has_pred = locs_pred is not None
    if has_pred:
        locs_pred = np.atleast_2d(np.asarray(locs_pred, dtype=np.float64))
        both = np.vstack([locs, locs_pred])
        _, counts = np.unique(both, axis=0, return_counts=True)
        if np.any(counts > 1):
            raise ValueError("Prediction locations contain observed location(s), "
                             "remove redundancies.")

    if m > n:
        warnings.warn("Conditioning set size m chosen to be larger than n. "
                      "Changing to m=n-1")
        m = n - 1

    # fully independent case
    if m == 0:
        if has_pred:
            warnings.warn("Attempting to make predictions with m=0. Prediction ignored")
        ordv = np.arange(n)
        NNarray = np.arange(n, dtype=np.int32)[:, None]
        cond = np.ones((n, 1), dtype=bool)
        return VecchiaSpec(
            locsord=locs, NNarray=NNarray, cond_latent=cond,
            has_latent=np.ones(n, bool), has_obs=np.ones(n, bool),
            ord=ordv, ord_z=ordv.copy(), ordering_pred="general",
            cond_yz="m0", conditioning="NN", ic0=ic0, n_obs=n, n_pred=0)

    # subsume firstm into mra (low-rank: r=(m, 1))
    user_conditioning = conditioning
    if conditioning == "firstm":
        conditioning = "mra"
        mra_options = {"r": [m, 1]}

    # default options
    if ordering is None:
        ordering = "coord" if d == 1 else "maxmin"
    if conditioning == "mra" and ordering != "maxmin":
        warnings.warn("ordering for the selected conditioning scheme changed "
                      "to required 'maxmin'")
        ordering = "maxmin"
    if cond_yz is None:
        if conditioning == "mra":
            cond_yz = "y"
        elif (not has_pred) or d == 1:
            cond_yz = "SGV"
        else:
            cond_yz = "zy"

    # ---- order locations ----
    if not has_pred:
        if ordering == "coord":
            ordv = order_coordinate(locs)
        elif ordering == "maxmin":
            ordv = order_maxmin_exact(locs)
            # head rotation: move ranks 2..9 to the end so that early points
            # get full conditioning sets (R/vecchia_specify.R:105-106)
            cut = min(n, 9)
            ordv = np.concatenate([ordv[:1], ordv[cut:], ordv[1:cut]])
        elif ordering == "outsidein":
            ordv = order_outsidein(locs)
        elif ordering == "none":
            ordv = np.arange(n)
        else:
            raise ValueError(f"ordering='{ordering}' not defined")
        ord_z = ordv.copy()
        locsord = locs[ordv]
        obs = np.ones(n, dtype=bool)
        ordering_pred = "general"
        n_pred = 0
    else:
        n_pred = locs_pred.shape[0]
        locs_all = np.vstack([locs, locs_pred])
        observed_stacked = np.concatenate([np.ones(n, bool), np.zeros(n_pred, bool)])
        if ordering_pred is None:
            ordering_pred = "general" if (d == 1 and ordering == "coord") else "obspred"
        if ordering_pred == "general":
            if ordering == "coord":
                ordv = order_coordinate(locs_all)
            else:
                ordv = order_maxmin_exact(locs_all)
            ord_obs = ordv[ordv < n]
        else:
            if ordering == "coord":
                ord_obs = order_coordinate(locs)
                ord_pred = order_coordinate(locs_pred)
            elif ordering == "none":
                ord_obs = np.arange(n)
                ord_pred = np.arange(n_pred)
            else:
                ord_obs, ord_pred = order_maxmin_exact_obs_pred(locs, locs_pred)
            ordv = np.concatenate([ord_obs, ord_pred + n])
        ord_z = ord_obs
        locsord = locs_all[ordv]
        obs = observed_stacked[ordv]

    n_locs = locsord.shape[0]

    # ---- conditioning sets ----
    mra_eff_m = None
    if conditioning == "mra":
        NNarray, mra_eff_m = find_ordered_nn_mra(locsord, mra_options, m,
                                                 verbose)
        if m == -1:
            m = NNarray.shape[1] - 1
    elif conditioning == "NN":
        NNarray = find_ordered_nn(locsord, m)
    else:
        raise ValueError(f"conditioning='{user_conditioning}' not defined")

    if has_pred and pred_cond == "independent":
        if ordering_pred == "obspred":
            # prediction rows condition only on the m nearest observed points
            # (R/vecchia_specify.R:168-178)
            nn_obs = knn_indices(locsord[:n], min(m, n), query=locsord[n:])
            mm = NNarray.shape[1]
            for j in range(n_pred):
                row = np.full(mm, -1, dtype=np.int64)
                row[0] = n + j
                k = min(m, n)
                row[1:1 + k] = np.sort(nn_obs[j][:k])[::-1]
                NNarray[n + j] = row
        else:
            warnings.warn("indep. conditioning currently only implemented for "
                          "obspred ordering")

    NNarray = NNarray.astype(np.int64)
    valid = NNarray >= 0
    first_pred = n  # ordered index of first prediction point (obspred layouts)

    # ---- latent (y) vs response (z) conditioning ----
    # In the general prediction ordering the prediction points are spread
    # over the sequence, so the index rule below (points from n on are
    # prediction points) does not find them: there every unobserved
    # neighbor is conditioned on through its latent afterwards (the JAX
    # package keeps the index rule and its plan then refuses the spec).
    general_pred = has_pred and ordering_pred == "general"
    if cond_yz == "SGV":
        cond = which_cond_on_latent(
            NNarray, firstind_pred=first_pred if has_pred and not general_pred
            else None)
    elif cond_yz == "SGVT":
        cond_obs = which_cond_on_latent(NNarray[:n])
        cond = np.vstack([cond_obs, np.ones((n_locs - n, NNarray.shape[1]), bool)])
        cond &= valid
    elif cond_yz == "y":
        cond = valid.copy()
    elif cond_yz == "z":
        cond = np.zeros_like(valid)
        cond[:, 0] = True
        if has_pred:
            # cannot condition on the response of an unobserved point
            cond |= (NNarray >= first_pred) & valid
        cond &= valid
    elif cond_yz in ("RVP", "LK", "zy"):
        return _specify_zy(locs, locsord, ordv, ord_z, obs, NNarray, valid, n,
                           n_pred, m, cond_yz, ordering_pred, ic0,
                           conditioning, has_pred)
    else:
        raise ValueError(f"cond_yz='{cond_yz}' not defined")
    if general_pred:
        cond |= valid & ~obs[np.where(valid, NNarray, 0)]

    return VecchiaSpec(
        locsord=locsord, NNarray=NNarray, cond_latent=cond & valid,
        has_latent=np.ones(n_locs, bool), has_obs=obs,
        ord=ordv, ord_z=ord_z, ordering_pred=ordering_pred,
        cond_yz=cond_yz, conditioning=conditioning, ic0=ic0,
        n_obs=n, n_pred=n_pred, mra_eff_m=mra_eff_m)


def _specify_zy(locs, locsord, ordv, ord_z, obs, NNarray, valid, n, n_pred, m,
                cond_yz, ordering_pred, ic0, conditioning, has_pred):
    """Response-first ('zy'/'RVP'/'LK') layouts, built natively.

    Point layout: k = 0..n-1 are pure-response points (the ordered observed
    locations, carrying only z); k = n..2n+n_pred-1 carry only latents (all
    ordered locations).  This reproduces the reference's dummy-row doubling
    (R/vecchia_specify.R:191-224) followed by dummy deletion
    (R/createU.R:166-171), without the surgery.
    """
    if has_pred and ordering_pred != "obspred":
        warnings.warn("ZY only implemented for obspred ordering")

    n_locs = locsord.shape[0]
    n_all = n + n_locs
    locsord_zy = np.vstack([locsord[:n], locsord])

    # nearest m-1 neighbors among observed locations (no ordering constraint)
    NNs = knn_indices(locsord[:n], m - 1)  # (n, m-1), 0-based ordered-obs idx
    if cond_yz in ("RVP", "zy"):
        # condition on latent y for previously-ordered neighbors
        prev = NNs < np.arange(n)[:, None]
        NNs = np.where(prev, NNs + n, NNs)

    mp1 = NNarray.shape[1]
    width = max(mp1, NNs.shape[1] + 2)

    # response rows: no conditioning
    NN_z = np.full((n, width), -1, dtype=np.int64)
    NN_z[:, 0] = np.arange(n)
    # latent rows for observed points: [self+n, own z, neighbors]
    NN_y = np.full((n, width), -1, dtype=np.int64)
    NN_y[:, 0] = np.arange(n) + n
    NN_y[:, 1] = np.arange(n)
    NN_y[:, 2:2 + NNs.shape[1]] = NNs
    # latent rows for prediction points
    if has_pred:
        NN_yp = NNarray[n:].copy()
        if NN_yp.shape[1] < width:
            NN_yp = np.hstack([NN_yp, np.full((n_pred, width - NN_yp.shape[1]), -1,
                                              dtype=np.int64)])
        vp = NN_yp >= 0
        if cond_yz == "zy":
            NN_yp[vp] += n
        else:  # RVP / LK: only latent (>= n) indices shift
            NN_yp[vp & (NN_yp >= n)] += n
    else:
        NN_yp = np.empty((0, width), dtype=np.int64)
        ordering_pred = "obspred"

    NN_all = np.vstack([NN_z, NN_y, NN_yp])
    valid_all = NN_all >= 0
    cond = (NN_all >= n) & valid_all
    cond[:, 0] = True
    cond &= valid_all

    has_latent = np.concatenate([np.zeros(n, bool), np.ones(n_locs, bool)])
    has_obs = np.concatenate([np.ones(n, bool), np.zeros(n_locs, bool)])

    return VecchiaSpec(
        locsord=locsord_zy, NNarray=NN_all, cond_latent=cond,
        has_latent=has_latent, has_obs=has_obs,
        ord=ordv, ord_z=ord_z, ordering_pred=ordering_pred,
        cond_yz=cond_yz, conditioning=conditioning, ic0=ic0,
        n_obs=n, n_pred=n_pred)
