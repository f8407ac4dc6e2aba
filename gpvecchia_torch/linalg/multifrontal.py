"""Multifrontal factor of W = sum_e u_e u_e^T + D with the RHS riding along.

Device half of the JAX package's ``linalg/multifrontal.py`` (``mf_factor``)
for the likelihood: forward only, in the augmented-RHS formulation on every
level.  The right-hand side b = sum_e rhs_elem[e] u_e + rhs_vert is front
row/column F1-1, so after the partial factor of a front its row F1-1 holds
y = L_pp^{-1} b (quad = sum y^2) and its trailing block is the augmented
Schur update the parent extend-adds.  Each level is

    leaf:      H2 leaf_assemble  -> H4 front_factor
    internal:  H3 extend_add     -> H4 front_factor

and a level's front is released as soon as its parent is assembled, so only
the Schur carry and the logdet/quad sums live across levels.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontal import extend_add, front_factor, leaf_assemble

__all__ = ["mf_device_arrays", "mf_factor"]


def mf_device_arrays(mf, device):
    """Per-level index tensors of an ``MFPlan`` (leaf last)."""
    levels = []
    D = mf.depth
    for d, lv in enumerate(mf.levels):
        P, B = lv.npiv, lv.nbord
        F1 = P + B + 1
        N = lv.piv_ids.shape[0]
        entry = dict(P=P, B=B, F1=F1,
                     piv_ids=torch.as_tensor(lv.piv_ids).long().to(device))
        if d < D:
            Bc1 = mf.levels[d + 1].nbord + 1
            ext_aug = np.full((N, 2, F1), -1, np.int32)
            ext_aug[:, :, :F1 - 1] = lv.ext
            ext_aug[:, :, F1 - 1] = Bc1 - 1
            entry["ext_aug"] = torch.as_tensor(ext_aug).to(device)
        else:
            entry["elem_pt"] = torch.as_tensor(lv.elem_pt).long().to(device)
            entry["elem_pos"] = torch.as_tensor(lv.elem_pos).to(device)
        levels.append(entry)
    return levels


def _piv_vec(piv_ids, vec, fill, F1):
    """(N, F1): vec at the pivot ids (padded pivots -> fill), 0 elsewhere."""
    N, P = piv_ids.shape
    ok = piv_ids >= 0
    v = torch.where(ok, vec[piv_ids.clamp(min=0)], fill)
    return torch.cat([v, vec.new_zeros(N, F1 - P)], dim=1)


def mf_factor(levels, u_elem, dvec, rhs_elem, rhs_vert):
    """(logdet W, b^T W^{-1} b) for W = sum_e u_e u_e^T + diag(dvec).

    u_elem: (E, K) element values aligned with the plan's element vertices
    (0 at absent slots); dvec, rhs_vert: (n_vert,); rhs_elem: (E,).
    Padded pivots get 1.0 on the diagonal and factor as exact 1s.
    """
    dt = u_elem.dtype
    logdet = u_elem.new_zeros(())
    quad = u_elem.new_zeros(())
    child = None
    for lv in reversed(levels):
        P, F1 = lv["P"], lv["F1"]
        dv = _piv_vec(lv["piv_ids"], dvec, 1.0, F1).to(dt)
        rv = _piv_vec(lv["piv_ids"], rhs_vert, 0.0, F1).to(dt)
        if child is None:
            ept = lv["elem_pt"]
            ok = ept >= 0
            ec = ept.clamp(min=0)
            u = torch.where(ok[..., None], u_elem[ec], 0.0)
            re = torch.where(ok, rhs_elem[ec], 0.0)
            front = leaf_assemble(u, lv["elem_pos"], re, dv, rv)
            del u, re
        else:
            # the children's Schur blocks, read in place from their fronts
            upd = child[:, child_P:, child_P:].unflatten(0, (-1, 2))
            front = extend_add(upd, lv["ext_aug"], dv, rv)
            del upd
        child = None
        front_factor(front, P)
        diag = torch.diagonal(front, dim1=1, dim2=2)[:, :P]
        logdet = logdet + 2.0 * torch.sum(torch.log(diag))
        y = front[:, F1 - 1, :P]
        quad = quad + torch.sum(y * y)
        child, child_P = front, P
    return logdet, quad
