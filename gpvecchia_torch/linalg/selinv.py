"""Takahashi selected inverse on the V factor, level-scheduled, in PyTorch.

The counterpart of the JAX package's ``linalg/selinv.py``: Z = (V V^T)^{-1}
restricted to the pattern of V, the posterior variances of the per-entry V
path (GPvecchia SelInv -> sparseinv::Takahashi_Davis,
R/vecchia_prediction.R:193-197).  Columns go by backward-solve level
(ancestors first); for column j with pattern s_j = [j, a_1, ..., a_F]:

    offd_i  = -(sum_k V[a_k, j] Z[a_k, a_i]) / V[j, j]          (i = 1..F)
    Z[a_i, j] = offd_i
    Z[j, j]   = 1 / V[j, j]^2 - (sum_k V[a_k, j] offd_k) / V[j, j]

Every Z entry a level reads lies in an ancestor column, computed at an
earlier level (the fill property of the symbolic pattern).  A level writes
its columns' Z entries at their own slots, each slot once (no sum through
colliding writes); pads write to a slot of their own that nothing reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SelInvLevel", "build_selinv_levels", "device_selinv_levels",
           "selected_inverse"]


@dataclasses.dataclass
class SelInvLevel:
    """A bucket of consecutive levels (ancestors first)."""
    F: int
    slots: np.ndarray       # (nlev, L, F) v/z flat slots of column j (diag first), -1 pad
    pair_slots: np.ndarray  # (nlev, L, F-1, F-1) z-flat slots of Z[a_k, a_i], -1 -> 0


def build_selinv_levels(plan):
    """Host-side: bucket-grouped slot maps for the Takahashi recursion.

    All slot indices are in the plan's PHYSICAL V layout (Z values share
    that layout, so v/z reads and z writes use the same maps).
    """
    colptr = plan.v_colptr
    rows = plan.v_rows.astype(np.int64)
    v_perm = plan.v_perm
    n = plan.n_lat
    # (row, col) -> PHYSICAL slot lookup over the V column storage
    col_of = np.repeat(np.arange(n), np.diff(colptr))
    keys = rows * n + col_of
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    slot_of = v_perm[order]

    def lookup(r, c):
        q = r.astype(np.int64) * n + c.astype(np.int64)
        pos = np.searchsorted(sorted_keys, q)
        pos_c = np.clip(pos, 0, sorted_keys.size - 1)
        ok = sorted_keys[pos_c] == q
        return np.where(ok, slot_of[pos_c], -1)

    # reuse the (already bucketed) backward levels: ancestors first
    out = []
    for blk in plan.bwd_blocks:
        nlev, L = blk.cols.shape
        cols_b = blk.cols.astype(np.int64)
        valid = cols_b >= 0
        cols_c = np.where(valid, cols_b, 0)
        widths = np.where(valid, colptr[cols_c + 1] - colptr[cols_c], 0)
        F = int(widths.max())
        ar = np.arange(F)[None, None, :]
        wmask = ar < widths[:, :, None]
        lslots = np.where(wmask, colptr[cols_c][:, :, None] + ar, 0)
        slots = np.where(wmask, v_perm[lslots], -1)
        if F > 1:
            anc = np.where(wmask[:, :, 1:], rows[lslots[:, :, 1:]], -1)
            av = anc >= 0
            aa = np.where(av, anc, 0)
            hi = np.maximum(aa[:, :, :, None], aa[:, :, None, :])
            lo = np.minimum(aa[:, :, :, None], aa[:, :, None, :])
            ps = lookup(hi.ravel(), lo.ravel()).reshape(nlev, L, F - 1, F - 1)
            ok = av[:, :, :, None] & av[:, :, None, :]
            ps = np.where(ok, ps, -1)
        else:
            ps = np.empty((nlev, L, 0, 0), dtype=np.int64)
        out.append(SelInvLevel(F=F, slots=slots.astype(np.int32),
                               pair_slots=ps.astype(np.int32)))
    return out


def device_selinv_levels(levels, device):
    """``build_selinv_levels``' buckets as (read slots, write slots, pair
    slots) long tensors on ``device``.  Read slots index ``V`` with a 1
    (-2, a pad column's diagonal) and a 0 (-1) appended; write slots send
    pads to -1, Z's write-only pad slot; pair slots send pads to -2, Z's
    zero slot."""
    out = []
    for lv in levels:
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device,
                                                                torch.long)
        read = lv.slots.astype(np.int64)
        read[..., 0] = np.where(read[..., 0] >= 0, read[..., 0], -2)
        ps = np.where(lv.pair_slots >= 0, lv.pair_slots, -2)
        out.append((t(read), t(lv.slots), t(ps)))
    return out


def selected_inverse(v_flat, levels, n_nnz):
    """Z values on V's pattern (physical layout, ``n_nnz`` of them) from
    V's values; ``levels`` from ``device_selinv_levels``."""
    v = torch.cat([v_flat, torch.tensor([1.0, 0.0], dtype=v_flat.dtype,
                                        device=v_flat.device)])
    z = v_flat.new_zeros(n_nnz + 2)           # [-2]: zero, [-1]: pad writes
    for read, write, ps in levels:
        for li in range(read.shape[0]):
            vv = v[read[li]]
            diag = vv[:, 0]
            zcol = (1.0 / (diag * diag))[:, None]
            if ps.shape[-1] > 0:
                lcol = vv[:, 1:]
                offd = -torch.einsum("bki,bk->bi", z[ps[li]], lcol) \
                    / diag[:, None]
                # Z[j,j] = 1/L_jj^2 - (1/L_jj) sum_k L[a_k,j] Z[a_k,j]
                zcol = torch.cat([zcol - (torch.sum(lcol * offd, dim=1)
                                          / diag)[:, None], offd], dim=1)
            z[write[li]] = zcol
    return z[:n_nnz]
