"""Likelihood plan: spec -> static index arrays (host-side, parameter-free).

A jax-free copy of the JAX package's ``plan.py``: ``build_likelihood_plan``
(mode selection and the per-point index arrays), ``get_plan``,
``get_mf_plan``, ``get_sel_pair_slots`` (the selected covariance layout's
lookup, with its packed form ``sel_pair_slots_packed``), and the per-entry
V machinery that ``ensure_v`` builds lazily for the plans the multifrontal
engine does not take (``mode`` 'direct' and 'obspred', and IC0).

V, the reverse-ordered Cholesky factor of W = U_y U_y^T + D (GPvecchia
R/vecchia_prediction.R:62-111 U2V), is held column-wise:

* 'direct' columns are reversed U columns copied verbatim (the zy family
  and the obspred prediction block, which need no factorization);
* 'chol' columns carry the factor on the symbolically filled pattern (or,
  with IC0, on the unfilled one, GPvecchia src/ic0.cpp:43-64) as an
  up-looking product schedule: every V entry (i, j) owns a host-built list
  of value pairs (U products assembling W[i, j], the 1/nugget diagonal,
  and V products V[i, k] V[j, k] of earlier columns), so each elimination
  level is one gather -> multiply -> reduce -> contiguous write step.

Every schedule is a list of padded gathers and one gather back into target
order: the device never sums through colliding writes, which keeps its
values bit-reproducible from run to run.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from .csrc import host
from .symbolic import csr_from_coo_lower, symbolic_cholesky
from .utils import trace

__all__ = ["LikelihoodPlan", "build_likelihood_plan", "get_plan",
           "ensure_v", "slot_sum_schedule", "get_mf_plan", "get_sel_pair_slots",
           "sel_pair_slots_packed"]


# --------------------------------------------------------------------------
# static schedule containers (numpy; moved to the device by the callers)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PairSumBucket:
    """Contiguous count-class segment: part[t] = sum_c A[pa[t,c]]*B[pb[t,c]].

    The device concatenates the class parts (plus a zero sentinel) and
    recombines them into target order with ONE static gather (`gather_map`
    on the schedule): no scatter, so no sum through colliding writes.
    """
    out_idx: np.ndarray     # (E,) int64 target slots (host bookkeeping only)
    pa: np.ndarray          # (E, C) int32 into A, -1 pad
    pb: np.ndarray          # (E, C) int32 into B, -1 pad


@dataclasses.dataclass
class PairSumSchedule:
    buckets: list           # of PairSumBucket
    gather_map: np.ndarray  # (n_out,) int32 into concat(parts)+[0] sentinel


@dataclasses.dataclass
class FactorBucket:
    """A bucket of consecutive elimination levels of the up-looking factor.

    The V value array uses a PHYSICAL layout ordered exactly like the
    computation: per level, the diagonal entries (grouped by product-count
    class, padded to E) come first, then the off-diagonal entries (ditto),
    so every level is one contiguous write — zero
    scatters.  All pa/pb/dloc indices are physical.

        raw_d  = w[seg] - sum v[pa]*v[pb]        (diag classes)
        raw_o  = w[seg] - sum v[pa]*v[pb]        (offdiag classes)
        level  = concat(sqrt(raw_d)..., raw_o * rsqrt(raw_d)[dloc]...)
    """
    S: int                  # per-level segment length (sum of padded classes)
    offsets: np.ndarray     # (nlev,) int32 physical start of each level
    diag_classes: list      # of (pa, pb): (nlev, E, C) int32, -1 pad
    off_classes: list       # of (pa, pb, dloc): dloc (nlev, E) into level diag


@dataclasses.dataclass
class FwdBlock:
    """A bucket of consecutive forward-solve levels (row-structure based).

    The solution vector x lives in a level-ordered physical layout; each
    level is one contiguous write.
    """
    cols: np.ndarray        # (nlev, L) int32 logical unknown ids (-1 pad)
    diag_slots: np.ndarray  # (nlev, L) int32 physical v slot of the diagonal
    row_slots: np.ndarray   # (nlev, L, R) int32 physical v slots, -1 pad
    row_cols: np.ndarray    # (nlev, L, R) int32 physical x positions, -1 pad
    offsets: np.ndarray     # (nlev,) int32 physical x start of each level


@dataclasses.dataclass
class SolveBlock:
    """A bucket of consecutive backward-solve levels (column-structure)."""
    cols: np.ndarray        # (nlev, L) logical column ids, -1 pad
    slots: np.ndarray       # (nlev, L, F) physical v slots (diag first)
    rows: np.ndarray        # (nlev, L, F) physical x positions, -1 pad
    offsets: np.ndarray     # (nlev,) int32 physical x start of each level


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
    # the spec the plan was built from (``ensure_v`` reads it)
    spec: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def use_mf(self) -> bool:
        """Whether the multifrontal engine handles the factor phase."""
        return self.mode == "chol" and not self.ic0 and self.n_lat > 0

    # V storage (``ensure_v``): logical pattern (column-major CSC) +
    # physical layout
    v_nnz: int = 0
    v_phys_size: int = 0
    v_colptr: np.ndarray | None = None
    v_rows: np.ndarray | None = None         # (v_nnz,) int32 logical rows
    v_perm: np.ndarray | None = None         # (v_nnz,) logical -> physical
    v_diag_slots: np.ndarray | None = None   # (n_lat,) PHYSICAL diag slots
    n_dir: int = 0                           # direct entries = phys [0, n_dir)
    dir_pt: np.ndarray | None = None         # (n_dir,) point ids
    dir_nn: np.ndarray | None = None         # (n_dir,) NNarray slot ids

    # gather-based schedules
    w_schedule: PairSumSchedule | None = None    # -> w in PHYSICAL layout
    factor_buckets: list = dataclasses.field(default_factory=list)
    z2_schedule: PairSumSchedule | None = None   # -> z2 (n_lat, logical)

    # triangular solve schedules (+ physical x layouts)
    fwd_blocks: list = dataclasses.field(default_factory=list)   # FwdBlock
    bwd_blocks: list = dataclasses.field(default_factory=list)   # SolveBlock
    fwd_x_size: int = 0
    fwd_x_perm: np.ndarray | None = None     # (n_lat,) logical -> physical
    bwd_x_size: int = 0
    bwd_x_perm: np.ndarray | None = None

    def to_logical(self, v_phys):
        """Physical V values -> logical column-major order."""
        return v_phys[self.v_perm]


# --------------------------------------------------------------------------
# small vectorized helpers
# --------------------------------------------------------------------------

def _ceil_pow2(x: int) -> int:
    return 1 << int(np.ceil(np.log2(max(int(x), 1))))


def _build_pair_sum(targets, pa, pb, n_out):
    """Group (target, pa, pb) triples into a scatter-free PairSumSchedule."""
    targets = np.asarray(targets, dtype=np.int64)
    gather_map = np.full(n_out, 0, dtype=np.int64)
    if targets.size == 0:
        return PairSumSchedule(buckets=[],
                               gather_map=gather_map.astype(np.int32))
    order = np.argsort(targets, kind="stable")
    pa_s = np.asarray(pa, dtype=np.int64)[order]
    pb_s = np.asarray(pb, dtype=np.int64)[order]
    counts = np.bincount(targets, minlength=n_out)
    uniq = np.flatnonzero(counts)
    offs = np.zeros(n_out + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    cls = np.ceil(np.log2(np.maximum(counts[uniq], 1))).astype(np.int64)
    buckets = []
    pos = 0
    for c in np.unique(cls):
        sel = uniq[cls == c]
        C = int(counts[sel].max())
        ar = np.arange(C)[None, :]
        ok = ar < counts[sel][:, None]
        idx = offs[sel][:, None] + ar
        idx_c = np.minimum(idx, pa_s.size - 1)
        buckets.append(PairSumBucket(
            out_idx=sel,
            pa=np.where(ok, pa_s[idx_c], -1).astype(np.int32),
            pb=np.where(ok, pb_s[idx_c], -1).astype(np.int32)))
        gather_map[sel] = pos + np.arange(sel.size)
        pos += sel.size
    # targets with no sources read the zero sentinel appended at `pos`
    gather_map[counts == 0] = pos
    return PairSumSchedule(buckets=buckets,
                           gather_map=gather_map.astype(np.int32))


def slot_sum_schedule(NN, mask, n_out) -> PairSumSchedule:
    """The pair-sum schedule that sums an (n, F) per-slot array into the
    points NN[i, j] of its ``mask`` slots (a slot -> point CSR in count
    classes; each point's slots in ascending flat order).  ``pa`` holds the
    flat slot ids, ``pb`` is unused (a copy of ``pa``)."""
    import scipy.sparse as sp
    slots = np.flatnonzero(np.asarray(mask).ravel())
    targets = np.asarray(NN).ravel()[slots].astype(np.int64)
    # a counting sort by target that keeps the slots ascending (no sum:
    # the column of each entry is its own slot)
    csr = sp.coo_matrix((np.ones(slots.size, np.int8), (targets, slots)),
                        shape=(n_out, max(int(np.size(NN)), 1))).tocsr()
    srt = csr.indices.astype(np.int64)
    tgt = np.repeat(np.arange(n_out), np.diff(csr.indptr))
    return _build_pair_sum(tgt, srt, srt, n_out)


def _level_groups(levels):
    """Column ids grouped by ascending level; list of int64 arrays."""
    order = np.argsort(levels, kind="stable")
    lv_sorted = levels[order]
    bounds = np.flatnonzero(np.diff(lv_sorted)) + 1
    return np.split(order, bounds)


def _bucket_by_keys(keys):
    """Partition consecutive levels into buckets; new bucket on key change."""
    bounds = [0]
    prev = None
    for i, k in enumerate(keys):
        if prev is not None and k != prev:
            bounds.append(i)
        prev = k
    bounds.append(len(keys))
    return bounds


def _solve_levels(colptr, rows, n, direction):
    """Per-column solve levels (native single pass; numpy wave fallback)."""
    out = host.solve_levels(colptr, rows, n, direction)
    if out is not None:
        return out
    level = np.ones(n, dtype=np.int64)
    col_of = np.repeat(np.arange(n), np.diff(colptr))
    offd = rows != col_of
    if direction == "fwd":
        src, dst = col_of[offd], rows[offd]
    else:
        src, dst = rows[offd], col_of[offd]
    while True:
        new = level.copy()
        np.maximum.at(new, dst, level[src] + 1)
        if np.array_equal(new, level):
            return level
        level = new


def _symbolic_chol_flat(W):
    """Filled-pattern CSC (colptr, rows) of chol(W); rows ascending, diag 1st."""
    out = host.symbolic_chol_flat(W.indptr, W.indices, W.n)
    if out is not None:
        colptr, rows, _ = out
        return colptr, rows
    col_arrays, _, _ = symbolic_cholesky(W)
    widths = np.array([c.size for c in col_arrays], dtype=np.int64)
    colptr = np.zeros(W.n + 1, dtype=np.int64)
    np.cumsum(widths, out=colptr[1:])
    rows = (np.concatenate(col_arrays) if col_arrays
            else np.empty(0, np.int64))
    return colptr, rows


def _csc_transpose_pattern(colptr, rows, n):
    """Lower CSC -> per-row (ptr, order) listing each row's entry slots.

    Returns (row_ptr, slot_by_row, col_by_row): entries sorted by (row, col);
    slot_by_row are flat indices into the CSC value array.
    """
    col_of = np.repeat(np.arange(n), np.diff(colptr))
    keys = rows.astype(np.int64) * n + col_of
    order = np.argsort(keys, kind="stable")
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    return row_ptr, order, col_of[order]


# --------------------------------------------------------------------------
# factor schedule (up-looking exact Cholesky / IC0 on the static pattern)
# --------------------------------------------------------------------------

_COUNT_CLASSES = (0, 4, 16, 64, 256, 1024, 4096, 16384, 65536, 262144)


def _build_factor_buckets(colptr, v_rows, n_lat, rev_offset, n_A,
                          tgt_v, pa_v, pb_v):
    """Physical level/class layout of V + factor schedule.

    Returns (buckets, v_perm, v_phys_size): entries are laid out so that
    every elimination level occupies one contiguous padded segment
    (diag-class segments first, then offdiag-class segments), all within a
    bucket sharing the same segment shape so the bucket runs as one
    loop of gather -> reduce -> contiguous write steps.
    """
    v_nnz = int(v_rows.size)
    n_dir = int(colptr[rev_offset])
    v_perm = np.empty(v_nnz, dtype=np.int64)
    v_perm[:n_dir] = np.arange(n_dir)
    if n_A == 0:
        return [], v_perm, n_dir

    colptr_A = colptr[rev_offset:] - n_dir
    rows_A = v_rows[n_dir:] - rev_offset
    lev_col = _solve_levels(colptr_A, rows_A, n_A, "fwd")

    # sorted V-product triples + per-logical-slot offsets
    tgt_v = np.asarray(tgt_v, dtype=np.int64)
    order = np.argsort(tgt_v, kind="stable")
    pa_s = np.asarray(pa_v, dtype=np.int64)[order]
    pb_s = np.asarray(pb_v, dtype=np.int64)[order]
    counts = np.bincount(tgt_v, minlength=v_nnz) if tgt_v.size else \
        np.zeros(v_nnz, dtype=np.int64)
    offs = np.zeros(v_nnz + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])

    # flat chol-entry descriptors
    slots_all = np.arange(n_dir, v_nnz, dtype=np.int64)
    widths = np.diff(colptr)
    col_all = np.repeat(np.arange(rev_offset, n_lat), widths[rev_offset:])
    lev_all = lev_col[col_all - rev_offset]
    isdiag = slots_all == colptr[col_all]
    part_all = np.where(isdiag, 0, 1)
    cnt_all = counts[slots_all]
    assert cnt_all.max(initial=0) <= _COUNT_CLASSES[-1]
    cls_all = np.searchsorted(np.asarray(_COUNT_CLASSES), cnt_all)

    nclasses = len(_COUNT_CLASSES)
    n_levels = int(lev_all.max()) if lev_all.size else 0
    ecounts = np.zeros((n_levels + 1, 2, nclasses), dtype=np.int64)
    np.add.at(ecounts, (lev_all, part_all, cls_all), 1)
    order_e = np.lexsort((slots_all, cls_all, part_all, lev_all))
    slots_sorted = slots_all[order_e]
    col_sorted = col_all[order_e]
    cnt_sorted = cnt_all[order_e]
    seg_off = np.zeros(ecounts.size + 1, dtype=np.int64)
    np.cumsum(ecounts.ravel(), out=seg_off[1:])

    def seg(l, p, c):
        i = (l * 2 + p) * nclasses + c
        return seg_off[i], seg_off[i + 1]

    present_d = np.flatnonzero(ecounts[:, 0, :].sum(axis=0) > 0)
    present_o = np.flatnonzero(ecounts[:, 1, :].sum(axis=0) > 0)

    keys = [tuple(_ceil_pow2(int(ecounts[l, p, c])) if ecounts[l, p, c] else 0
                  for p, pres in ((0, present_d), (1, present_o))
                  for c in pres)
            for l in range(1, n_levels + 1)]
    bounds = _bucket_by_keys(keys)

    # ---- pass 1: assign physical positions (and per-level diag positions) ----
    phys = n_dir
    dpos_of_col = np.full(n_lat, -1, dtype=np.int64)
    bucket_meta = []          # (lv_lo, lv_hi, S, offsets, Ed list, Eo list)
    for s, e in zip(bounds[:-1], bounds[1:]):
        lv_lo, lv_hi = s + 1, e + 1
        nlev = e - s
        Ed = [int(ecounts[lv_lo:lv_hi, 0, c].max()) for c in present_d]
        Eo = [int(ecounts[lv_lo:lv_hi, 1, c].max()) for c in present_o]
        S = sum(Ed) + sum(Eo)
        offsets = phys + np.arange(nlev, dtype=np.int64) * S
        for li, l in enumerate(range(lv_lo, lv_hi)):
            pos = offsets[li]
            dbase = 0
            for c, E in zip(present_d, Ed):
                a, b = seg(l, 0, c)
                k = b - a
                v_perm[slots_sorted[a:b]] = pos + np.arange(k)
                dpos_of_col[col_sorted[a:b]] = dbase + np.arange(k)
                pos += E
                dbase += E
            for c, E in zip(present_o, Eo):
                a, b = seg(l, 1, c)
                v_perm[slots_sorted[a:b]] = pos + np.arange(b - a)
                pos += E
        phys += nlev * S
        bucket_meta.append((lv_lo, lv_hi, S, offsets, Ed, Eo))
    v_phys_size = int(phys)

    # ---- pass 2: build padded class arrays (physical product operands) ----
    pa_phys = v_perm[pa_s] if pa_s.size else pa_s
    pb_phys = v_perm[pb_s] if pb_s.size else pb_s

    def padded_products(l_range, p, c, E):
        nlev = len(l_range)
        C = int(_COUNT_CLASSES[c])
        cntb = np.zeros((nlev, E), dtype=np.int64)
        offb = np.zeros((nlev, E), dtype=np.int64)
        colb = np.zeros((nlev, E), dtype=np.int64)
        for li, l in enumerate(l_range):
            a, b = seg(l, p, c)
            k = b - a
            cntb[li, :k] = cnt_sorted[a:b]
            offb[li, :k] = offs[slots_sorted[a:b]]
            colb[li, :k] = col_sorted[a:b]
        if C == 0:
            z = np.empty((nlev, E, 0), dtype=np.int32)
            return z, z, colb
        arc = np.arange(C)
        okc = arc[None, None, :] < cntb[..., None]
        idx = np.minimum(offb[..., None] + arc, max(pa_phys.size - 1, 0))
        pa = np.where(okc, pa_phys[idx] if pa_phys.size else -1, -1)
        pb = np.where(okc, pb_phys[idx] if pb_phys.size else -1, -1)
        return pa.astype(np.int32), pb.astype(np.int32), colb

    buckets = []
    for lv_lo, lv_hi, S, offsets, Ed, Eo in bucket_meta:
        l_range = range(lv_lo, lv_hi)
        diag_classes = []
        for c, E in zip(present_d, Ed):
            if E == 0:
                continue
            pa, pb, _ = padded_products(l_range, 0, c, E)
            diag_classes.append((pa, pb, E))
        off_classes = []
        for c, E in zip(present_o, Eo):
            if E == 0:
                continue
            pa, pb, colb = padded_products(l_range, 1, c, E)
            dloc = dpos_of_col[colb].astype(np.int32)
            off_classes.append((pa, pb, dloc, E))
        buckets.append(FactorBucket(
            S=S, offsets=offsets.astype(np.int32),
            diag_classes=diag_classes, off_classes=off_classes))
    return buckets, v_perm, v_phys_size


def _build_v_product_triples(colptr, v_rows, n_lat, rev_offset, slot_lookup,
                             ic0, chunk=4_000_000):
    """(tgt_slot, pa, pb) for all V-products V[i,k]*V[j,k] -> entry (i,j).

    Enumerated per source column k over its below-diagonal pairs; in exact
    mode every product's target lies in the filled pattern (asserted); in
    IC0 mode out-of-pattern targets are dropped (that IS the approximation,
    GPvecchia src/ic0.cpp:43-64).
    """
    n_A_cols = n_lat - rev_offset
    if n_A_cols <= 0:
        z = np.empty(0, np.int64)
        return z, z, z
    widths = np.diff(colptr)[rev_offset:]
    Fmax = int(widths.max()) if widths.size else 0
    if Fmax <= 1:
        z = np.empty(0, np.int64)
        return z, z, z
    ia, ib = np.tril_indices(Fmax - 1)
    pia = (ia + 1).astype(np.int64)
    pib = (ib + 1).astype(np.int64)
    P = pia.size
    cols_per_chunk = max(1, chunk // max(P, 1))
    tg_l, pa_l, pb_l = [], [], []
    for s in range(0, n_A_cols, cols_per_chunk):
        e = min(s + cols_per_chunk, n_A_cols)
        cols_g = np.arange(s, e) + rev_offset
        w = widths[s:e]
        base = colptr[cols_g]
        # padded row matrix for the chunk
        F = int(w.max())
        sel = (pia < F) & (pib < F) if F < Fmax else slice(None)
        pia_c, pib_c = pia[sel] if F < Fmax else pia, pib[sel] if F < Fmax else pib
        ar = np.arange(F)[None, :]
        okw = ar < w[:, None]
        R = np.where(okw, v_rows[np.minimum(base[:, None] + ar,
                                            v_rows.size - 1)], -1)
        va = R[:, pia_c]            # larger row (ascending within column)
        vb = R[:, pib_c]
        ok = va >= 0                # pia >= pib, pad at tail
        tgt = slot_lookup(np.where(ok, vb, 0), np.where(ok, va, 0))
        if ic0:
            ok = ok & (tgt >= 0)
        else:
            assert np.all(tgt[ok] >= 0), \
                "V-product target missing from the filled pattern"
        pa = base[:, None] + pia_c[None, :]
        pb = base[:, None] + pib_c[None, :]
        tg_l.append(tgt[ok])
        pa_l.append(np.broadcast_to(pa, ok.shape)[ok])
        pb_l.append(np.broadcast_to(pb, ok.shape)[ok])
    return (np.concatenate(tg_l), np.concatenate(pa_l), np.concatenate(pb_l))


def _x_layout(groups, bounds):
    """Physical x layout for a solve direction: per-bucket padded levels."""
    n = sum(g.size for g in groups)
    x_perm = np.empty(n, dtype=np.int64)
    offsets_all = []
    pos = 0
    for s, e in zip(bounds[:-1], bounds[1:]):
        L = max(groups[i].size for i in range(s, e))
        offs = pos + np.arange(e - s, dtype=np.int64) * L
        for li in range(s, e):
            g = groups[li]
            x_perm[g] = offs[li - s] + np.arange(g.size)
        offsets_all.append(offs)
        pos += (e - s) * L
    return x_perm, offsets_all, pos


def _build_fwd_blocks(colptr, v_rows, n_lat, v_perm):
    """Row-structure forward-solve schedule, physical layouts, no scatters."""
    lev = _solve_levels(colptr, v_rows, n_lat, "fwd")
    row_ptr, slot_by_row, col_by_row = _csc_transpose_pattern(
        colptr, v_rows, n_lat)
    # strip diagonal entries (col == row)
    offd = col_by_row != np.repeat(np.arange(n_lat), np.diff(row_ptr))
    slot_by_row = slot_by_row[offd]
    col_by_row = col_by_row[offd]
    rcnt = np.bincount(v_rows[v_rows != np.repeat(
        np.arange(n_lat), np.diff(colptr))], minlength=n_lat)
    roff = np.zeros(n_lat + 1, dtype=np.int64)
    np.cumsum(rcnt, out=roff[1:])

    groups = _level_groups(lev)
    keys = [( _ceil_pow2(g.size),
              _ceil_pow2(max(int(rcnt[g].max()) if g.size else 0, 1)))
            for g in groups]
    bounds = _bucket_by_keys(keys)
    x_perm, offsets_all, x_size = _x_layout(groups, bounds)
    slot_phys = v_perm[slot_by_row] if slot_by_row.size else slot_by_row
    colx_phys = x_perm[col_by_row] if col_by_row.size else col_by_row

    blocks = []
    for bi, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
        nlev = e - s
        L = max(groups[i].size for i in range(s, e))
        R = max(int(rcnt[groups[i]].max()) if groups[i].size else 0
                for i in range(s, e))
        cols = np.full((nlev, L), -1, dtype=np.int64)
        for li in range(s, e):
            cols[li - s, :groups[li].size] = groups[li]
        okc = cols >= 0
        cc = np.where(okc, cols, 0)
        diag_slots = np.where(okc, v_perm[colptr[cc]], -1)
        if R > 0:
            ar = np.arange(R)
            okr = (ar[None, None, :] < rcnt[cc][..., None]) & okc[..., None]
            idx = roff[cc][..., None] + ar
            idx_c = np.minimum(idx, max(slot_phys.size - 1, 0))
            row_slots = np.where(okr, slot_phys[idx_c]
                                 if slot_phys.size else -1, -1)
            row_cols = np.where(okr, colx_phys[idx_c]
                                if colx_phys.size else -1, -1)
        else:
            row_slots = np.empty((nlev, L, 0), dtype=np.int64)
            row_cols = row_slots
        blocks.append(FwdBlock(cols=cols.astype(np.int32),
                               diag_slots=diag_slots.astype(np.int32),
                               row_slots=row_slots.astype(np.int32),
                               row_cols=row_cols.astype(np.int32),
                               offsets=offsets_all[bi].astype(np.int32)))
    return blocks, x_perm, x_size


def _build_bwd_blocks(colptr, v_rows, n_lat, v_perm):
    """Column-structure backward-solve schedule, physical layouts."""
    lev = _solve_levels(colptr, v_rows, n_lat, "bwd")
    widths = np.diff(colptr)
    groups = _level_groups(lev)
    keys = [(_ceil_pow2(g.size),
             _ceil_pow2(max(int(widths[g].max()) if g.size else 0, 1)))
            for g in groups]
    bounds = _bucket_by_keys(keys)
    x_perm, offsets_all, x_size = _x_layout(groups, bounds)
    rows_x = np.concatenate([x_perm[v_rows], [-1]]) if v_rows.size else \
        np.asarray([-1], dtype=np.int64)
    slots_phys = np.concatenate([v_perm, [-1]]) if v_rows.size else \
        np.asarray([-1], dtype=np.int64)

    blocks = []
    for bi, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
        nlev = e - s
        L = max(groups[i].size for i in range(s, e))
        F = max(int(widths[groups[i]].max()) for i in range(s, e))
        cols = np.full((nlev, L), -1, dtype=np.int64)
        for li in range(s, e):
            cols[li - s, :groups[li].size] = groups[li]
        okc = cols >= 0
        cc = np.where(okc, cols, 0)
        ar = np.arange(F)
        okf = (ar[None, None, :] < widths[cc][..., None]) & okc[..., None]
        lslots = np.where(okf, colptr[cc][..., None] + ar, v_rows.size)
        slots = np.where(okf, slots_phys[lslots], -1)
        rws = np.where(okf, rows_x[lslots], -1)
        blocks.append(SolveBlock(cols=cols.astype(np.int32),
                                 slots=slots.astype(np.int32),
                                 rows=rws.astype(np.int32),
                                 offsets=offsets_all[bi].astype(np.int32)))
    return blocks, x_perm, x_size


# --------------------------------------------------------------------------
# main plan builder
# --------------------------------------------------------------------------

@trace.span("plan.likelihood")
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
    plan.spec = spec
    return plan


def get_plan(spec) -> LikelihoodPlan:
    return spec.cached("likelihood_plan", lambda: build_likelihood_plan(spec))


def ensure_v(plan) -> "LikelihoodPlan":
    """Build the per-entry V-factor machinery lazily (first use).

    The multifrontal engine (plan.use_mf) does not need any of it; building
    it eagerly would redo the expensive symbolic factorization the engine
    was designed to avoid.  Prediction paths in 'obspred'/'direct' modes and
    the ic0 variant call this before touching v_* / solve-schedule fields.
    """
    if plan.v_colptr is not None:
        return plan
    _build_v_machinery(plan, plan.spec)
    return plan


def _build_v_machinery(plan, spec):
    """Per-entry V pattern, factor schedule and solve schedules (heavy)."""
    mode = plan.mode
    n_all, mp1 = plan.NN.shape
    n_lat = plan.n_lat
    n_obs = plan.n_obs
    NN_c = plan.NN.astype(np.int64)
    cond = plan.cond
    has_lat = plan.has_latent_pts
    has_obs = spec.has_obs
    latent_rank = spec.latent_rank
    obs_pos = spec.obs_pos
    revlat = np.where(has_lat, n_lat - 1 - latent_rank, -1)
    known = plan.known_pts if plan.known_pts is not None \
        else np.zeros(n_all, dtype=bool)
    has_col = has_lat | known
    u_rows_rev = np.where(cond, revlat[NN_c], -1)
    u_rows_rev = np.where(has_col[:, None], u_rows_rev, -1)

    # ---- decide which latent columns are 'direct' vs 'chol' ----
    # direct cols occupy the leading rev block [0, rev_offset), chol columns
    # the trailing block [rev_offset, n_lat)
    if mode == "direct":
        rev_offset = n_lat
    elif mode == "obspred":
        rev_offset = plan.n_pred_lat
    else:
        rev_offset = 0
    n_A = n_lat - rev_offset

    # ---- direct columns: reversed U columns, vectorized extraction ----
    lat_points = spec.latent_point        # latent rank -> point id
    if rev_offset > 0:
        # direct rev cols j = 0..rev_offset-1; latent rank c = n_lat-1-j
        dp = lat_points[n_lat - 1 - np.arange(rev_offset)]
        cnd = cond[dp]                                    # (D, mp1)
        rows_mat = np.where(cnd, revlat[NN_c[dp]], np.iinfo(np.int64).max)
        ordm = np.argsort(rows_mat, axis=1, kind="stable")
        rows_sorted = np.take_along_axis(rows_mat, ordm, axis=1)
        dwidths = cnd.sum(axis=1)
        dmask = np.arange(mp1)[None, :] < dwidths[:, None]
        dir_rows_flat = rows_sorted[dmask]
        dir_nn = np.broadcast_to(ordm, rows_sorted.shape)[dmask]
        dir_pt = np.broadcast_to(dp[:, None], rows_sorted.shape)[dmask]
    else:
        dwidths = np.empty(0, np.int64)
        dir_rows_flat = dir_nn = dir_pt = np.empty(0, np.int64)

    # ---- chol columns: W pattern + symbolic factorization (A-space) ----
    if n_A > 0:
        # known (zero-nugget) columns are not V columns but still add
        # u u^T to W over their latent-conditioned rows — all of which sit
        # in the A block (obs rows never condition on pred latents)
        contrib = (has_lat & (latent_rank >= 0)
                   & (latent_rank < n_A)) | known
        assert not np.any((u_rows_rev[known] >= 0)
                          & (u_rows_rev[known] < rev_offset)), \
            "known column conditions on a direct-block latent"
        rr_all = np.where(contrib[:, None], u_rows_rev - rev_offset, -1)
        iu, ju = np.triu_indices(mp1)
        # W pattern from contributing U-column pairs (chunked)
        pts = np.flatnonzero(contrib)
        hi_l, lo_l = [], []
        chunk_pts = max(1, 8_000_000 // max(iu.size, 1))
        for s in range(0, pts.size, chunk_pts):
            p = pts[s:s + chunk_pts]
            A_r = rr_all[p][:, iu]
            B_r = rr_all[p][:, ju]
            ok = (A_r >= 0) & (B_r >= 0)
            hi_l.append(np.maximum(A_r, B_r)[ok])
            lo_l.append(np.minimum(A_r, B_r)[ok])
        hi = np.concatenate(hi_l) if hi_l else np.empty(0, np.int64)
        lo = np.concatenate(lo_l) if lo_l else np.empty(0, np.int64)
        W0 = csr_from_coo_lower(n_A, hi, lo)

        if spec.ic0:
            # incomplete factorization: keep the unfilled pattern (CSC from
            # the lower-CSR rows via transpose)
            rows_rep = np.repeat(np.arange(n_A), np.diff(W0.indptr))
            order = np.argsort(W0.indices, kind="stable")
            srt_cols = W0.indices[order]
            srt_rows = rows_rep[order]
            colptr_A = np.zeros(n_A + 1, dtype=np.int64)
            np.cumsum(np.bincount(srt_cols, minlength=n_A), out=colptr_A[1:])
            # rows within each column ascending (stable sort preserves)
            rows_A = srt_rows
        else:
            colptr_A, rows_A = _symbolic_chol_flat(W0)
    else:
        colptr_A = np.zeros(1, dtype=np.int64)
        rows_A = np.empty(0, np.int64)

    # ---- merge direct + chol into global V column storage ----
    widths = np.concatenate([dwidths, np.diff(colptr_A)])
    colptr = np.zeros(n_lat + 1, dtype=np.int64)
    np.cumsum(widths, out=colptr[1:])
    v_rows = np.concatenate([dir_rows_flat, rows_A + rev_offset]) \
        if n_lat else np.empty(0, np.int64)
    plan.v_nnz = int(v_rows.size)
    plan.v_colptr = colptr
    plan.v_rows = v_rows.astype(np.int32)
    assert np.array_equal(v_rows[colptr[:-1]], np.arange(n_lat)), \
        "diag must lead each V column"

    # direct entries occupy physical [0, n_dir) in logical (col-major) order
    plan.n_dir = int(dir_rows_flat.size)
    plan.dir_pt = dir_pt.astype(np.int32)
    plan.dir_nn = dir_nn.astype(np.int32)

    # ---- value-slot lookup over the V pattern ----
    col_of = np.repeat(np.arange(n_lat), widths)
    vkeys = col_of * n_lat + v_rows        # ascending (col-major, rows asc)

    def slot_lookup(cols_q, rows_q):
        q = cols_q.astype(np.int64) * n_lat + rows_q.astype(np.int64)
        pos = np.searchsorted(vkeys, q)
        pos_c = np.minimum(pos, max(vkeys.size - 1, 0))
        ok = vkeys[pos_c] == q if vkeys.size else np.zeros(q.shape, bool)
        return np.where(ok, pos_c, -1)

    # ---- V-product schedule + factor buckets + physical V layout ----
    if n_A > 0:
        tgt_v, pa_v, pb_v = _build_v_product_triples(
            colptr, v_rows, n_lat, rev_offset, slot_lookup, spec.ic0)
    else:
        tgt_v = pa_v = pb_v = np.empty(0, np.int64)
    plan.factor_buckets, v_perm, plan.v_phys_size = _build_factor_buckets(
        colptr, v_rows, n_lat, rev_offset, n_A, tgt_v, pa_v, pb_v)
    plan.v_perm = v_perm.astype(np.int64)
    plan.v_diag_slots = v_perm[colptr[:-1]].astype(np.int32)

    if n_A > 0:
        # ---- W assembly schedule: out[t] = sum U[p,a]*U[p,b] (+ D diag) ----
        # targets in the PHYSICAL layout (feeds the factor body directly)
        off_d = n_all * mp1                   # 1/nugget values
        off_one = off_d + n_obs               # literal 1.0
        tg_l, pa_l, pb_l = [], [], []
        for s in range(0, pts.size, chunk_pts):
            p = pts[s:s + chunk_pts]
            rrp = rr_all[p]
            A_r = rrp[:, iu]
            B_r = rrp[:, ju]
            ok = (A_r >= 0) & (B_r >= 0)
            hi = np.maximum(A_r, B_r) + rev_offset
            lo = np.minimum(A_r, B_r) + rev_offset
            tgt = slot_lookup(np.where(ok, lo, 0), np.where(ok, hi, 0))
            assert np.all(tgt[ok] >= 0), "W entry outside factor pattern"
            base = (p[:, None] * mp1)
            pa = base + iu[None, :]
            pb = base + ju[None, :]
            tg_l.append(v_perm[tgt[ok]])
            pa_l.append(np.broadcast_to(pa, ok.shape)[ok])
            pb_l.append(np.broadcast_to(pb, ok.shape)[ok])
        # D diagonal: latent points with observations add 1/nugget
        dpts = np.flatnonzero(has_lat & has_obs & (latent_rank < n_A))
        if dpts.size:
            drev = n_lat - 1 - latent_rank[dpts]
            tg_l.append(v_perm[colptr[drev]])
            pa_l.append(off_d + obs_pos[dpts])
            pb_l.append(np.full(dpts.size, off_one, dtype=np.int64))
        plan.w_schedule = _build_pair_sum(
            np.concatenate(tg_l), np.concatenate(pa_l), np.concatenate(pb_l),
            plan.v_phys_size)

    # ---- z2 schedule: z2[r] = sum col[p,a]*z1L[p] - z1Z[o]/sqrt(nug)@own
    # (known zero-nugget columns contribute through their latent rows too) ----
    off_one_z = n_all * mp1
    src = cond & has_col[:, None]
    pidx, aidx = np.nonzero(src)
    tgt_z = latent_rank[NN_c[pidx, aidx]].astype(np.int64)
    pa_z = pidx * mp1 + aidx
    pb_z = pidx.astype(np.int64)
    lat_obs_pts = np.flatnonzero(has_lat & has_obs)
    if lat_obs_pts.size:
        tgt_z = np.concatenate([tgt_z, latent_rank[lat_obs_pts]])
        pa_z = np.concatenate([pa_z,
                               np.full(lat_obs_pts.size, off_one_z, np.int64)])
        pb_z = np.concatenate([pb_z, n_all + obs_pos[lat_obs_pts]])
    plan.z2_schedule = _build_pair_sum(tgt_z, pa_z, pb_z, n_lat)

    # ---- solve schedules ----
    plan.fwd_blocks, plan.fwd_x_perm, plan.fwd_x_size = _build_fwd_blocks(
        colptr, v_rows, n_lat, v_perm)
    plan.bwd_blocks, plan.bwd_x_perm, plan.bwd_x_size = _build_bwd_blocks(
        colptr, v_rows, n_lat, v_perm)

    return plan


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
