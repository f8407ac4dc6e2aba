"""Likelihood plan: spec -> static index arrays (host-side, parameter-free).

A jax-free copy of the JAX package's ``plan.build_likelihood_plan`` (mode
selection and the per-point index arrays), ``get_plan``, ``get_mf_plan``
and ``get_sel_pair_slots`` (the selected covariance layout's lookup,
with its packed form ``sel_pair_slots_packed``).
The per-entry V-factor machinery and the symbolic factorization are not
copied: the port runs only the multifrontal ('chol', ``use_mf``) path, and
every other mode raises ``NotImplementedError`` in the likelihood.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

__all__ = ["LikelihoodPlan", "build_likelihood_plan", "get_plan",
           "get_mf_plan", "get_sel_pair_slots", "sel_pair_slots_packed"]


@dataclasses.dataclass
class LikelihoodPlan:
    mode: str               # 'chol' | 'obspred' | 'direct'
    n_all: int
    n_lat: int
    n_obs: int
    n_pred_lat: int         # latent vars handled as direct pred columns

    locs: np.ndarray
    NN: np.ndarray          # (n_all, m+1) int32, clamped to >= 0
    valid: np.ndarray
    cond: np.ndarray
    has_latent_pts: np.ndarray   # (n_all,) bool
    latent_rank: np.ndarray      # (n_all,) int32 (-1 if none)
    obs_pos: np.ndarray          # (n_all,) int32 (-1 if unobserved)
    obs_points: np.ndarray       # (n_obs,) point index of each obs position
    ord_z: np.ndarray            # (n_obs,) user-z gather
    nb_obs_pos: np.ndarray       # (n_all, m+1) obs position of neighbors
    nb_resp: np.ndarray          # (n_all, m+1) bool: response-conditioned nb
    ic0: bool = False
    known_pts: np.ndarray | None = None   # zero-nugget (exact) observations
    zero_obs: np.ndarray | None = None    # (n_obs,) ordered-position mask
    cache: dict = dataclasses.field(default_factory=dict)

    @property
    def use_mf(self) -> bool:
        """Whether the multifrontal engine handles the factor phase."""
        return self.mode == "chol" and not self.ic0 and self.n_lat > 0


def build_likelihood_plan(spec) -> LikelihoodPlan:
    """Static per-point index arrays for the likelihood (dtype-free)."""
    NN = spec.NNarray.astype(np.int64)
    valid = NN >= 0
    cond = spec.cond_latent & valid
    n_all = NN.shape[0]
    n_lat = spec.n_latent
    latent_rank = spec.latent_rank
    obs_pos = spec.obs_pos
    has_lat = spec.has_latent
    has_obs = spec.has_obs
    n_obs = int(has_obs.sum())

    NN_c = np.where(valid, NN, 0)
    nb_obs_pos = np.where(valid, obs_pos[NN_c], -1)
    nb_resp = valid & ~cond
    # response-conditioned neighbors must be observed
    assert np.all(nb_obs_pos[nb_resp] >= 0), \
        "response conditioning on unobserved point"

    # 'direct' (V = reversed U columns) is the zy family; obspred layouts
    # with prediction points take the direct prediction block
    if spec.cond_yz in ("zy", "RVP", "LK"):
        mode = "direct"
    elif spec.ordering_pred == "obspred" and spec.n_pred > 0:
        mode = "obspred"
    else:
        mode = "chol"

    plan = LikelihoodPlan(
        mode=mode, n_all=n_all, n_lat=n_lat, n_obs=n_obs, n_pred_lat=0,
        locs=spec.locsord, NN=NN_c.astype(np.int32), valid=valid, cond=cond,
        has_latent_pts=has_lat, latent_rank=latent_rank.astype(np.int32),
        obs_pos=obs_pos.astype(np.int32),
        obs_points=np.flatnonzero(has_obs).astype(np.int32),
        ord_z=spec.ord_z.astype(np.int32),
        nb_obs_pos=np.where(nb_obs_pos >= 0, nb_obs_pos, 0).astype(np.int32),
        nb_resp=nb_resp, ic0=bool(spec.ic0))
    known = spec.known_pts
    if known is None:
        known = np.zeros(n_all, dtype=bool)
    plan.known_pts = known
    if spec.zero_obs_mask is not None:
        zero_obs = np.asarray(spec.zero_obs_mask, dtype=bool).copy()
    else:
        zero_obs = np.zeros(n_obs, dtype=bool)
        zero_obs[obs_pos[known & has_obs]] = True
    plan.zero_obs = zero_obs
    if mode == "obspred":
        plan.n_pred_lat = n_lat - int(has_lat[:spec.n_obs].sum())
    return plan


def get_plan(spec) -> LikelihoodPlan:
    return spec.cached("likelihood_plan", lambda: build_likelihood_plan(spec))


def get_mf_plan(plan, leaf_elems=128):
    """(MFPlan, vert_obs) for the 'chol'-mode factor (cached on the plan).

    Vertices are the latent ranks; element e (one per ordered point) lists
    the latent ranks of its latent-conditioned neighbors (self first) — the
    nonzero rows of U_y's column e, so W = U_y U_y^T + D = sum_e u_e u_e^T
    + diag(D).  ``vert_obs`` is the obs position of each vertex's point (-1
    if unobserved), used for the D diagonal and the direct RHS term.  The
    128-element leaves are the JAX package's default.
    """
    key = ("mf_plan", leaf_elems)
    if key in plan.cache:
        return plan.cache[key]
    from .linalg.mf_plan import build_mf_plan
    lr = plan.latent_rank.astype(np.int64)
    elem_verts = np.where(plan.cond, lr[plan.NN], -1)
    mf = build_mf_plan(elem_verts, plan.locs, plan.n_lat,
                       leaf_elems=leaf_elems)
    lat_pts = np.flatnonzero(plan.has_latent_pts)
    vert_obs = plan.obs_pos[lat_pts].astype(np.int32)
    plan.cache[key] = (mf, vert_obs)
    return plan.cache[key]


def _sel_slot_table(spec, ia, ib, chunk_rows=65536) -> np.ndarray:
    """(n_all, K) int32: for each row i and column pair (ia[k], ib[k]) the
    flat index of Sigma[NN[i,ia[k]], NN[i,ib[k]]] inside the flattened
    (n_all, m+1) selected matrix, found by hierarchical closure (the later
    of the two points lists the other in its own conditioning set); -1
    where the pair is invalid or not present (patterns that are not
    hierarchically closed: those pairs count as zero covariance, with a
    warning).  Rows go in chunks, so the temporaries stay bounded."""
    NN = spec.NNarray.astype(np.int64)
    n, mp1 = NN.shape
    valid = NN >= 0
    # lookup (row r, point q) -> flat slot r*mp1 + j
    rows = np.repeat(np.arange(n), mp1)[valid.ravel()]
    pts = NN[valid]
    keys = rows * n + pts
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    svals = (rows * mp1 + (np.tile(np.arange(mp1), n)[valid.ravel()]))[order]
    del rows, pts, keys, order

    out = np.empty((n, ia.size), np.int32)
    missing = False
    for s in range(0, n, chunk_rows):
        v = valid[s:s + chunk_rows]
        nn = np.where(v, NN[s:s + chunk_rows], 0)
        P, Q = nn[:, ia], nn[:, ib]
        ok = v[:, ia] & v[:, ib]
        q = np.maximum(P, Q) * n + np.minimum(P, Q)
        pos = np.clip(np.searchsorted(skeys, q), 0, skeys.size - 1)
        hit = skeys[pos] == q
        out[s:s + chunk_rows] = np.where(hit & ok, svals[pos], -1)
        missing = missing or bool((ok & ~hit).any())
    if missing:
        warnings.warn(
            "selected-covariance matrix cannot represent all conditioning "
            "pairs (pattern is not hierarchically closed); missing pairs "
            "treated as zero covariance")
    return out


def get_sel_pair_slots(spec) -> np.ndarray:
    """(n_all, m+1, m+1) int32 indices into a flattened (n_all, m+1)
    selected covariance matrix (cached on the spec): entry (i, a, b)
    locates Sigma[NN[i,a], NN[i,b]] inside the selected matrix (see
    ``_sel_slot_table``; -1 for pairs it cannot represent).  The JAX
    package's layout; the likelihood uses ``sel_pair_slots_packed``.
    """

    def build():
        mp1 = spec.NNarray.shape[1]
        ia, ib = np.divmod(np.arange(mp1 * mp1), mp1)
        return _sel_slot_table(spec, ia, ib).reshape(-1, mp1, mp1)

    return spec.cached("sel_pair_slots", build)


def sel_pair_slots_packed(spec) -> np.ndarray:
    """(n_all, P) int32, P = (m+1)(m+2)/2: the upper triangle (a <= b,
    row-major, as ``build_cov_packed`` packs its rows) of
    ``get_sel_pair_slots``, built from those pairs alone (not cached)."""
    ia, ib = np.triu_indices(spec.NNarray.shape[1])
    return _sel_slot_table(spec, ia, ib)
