"""Multifrontal factor of W = sum_e u_e u_e^T + D with the RHS riding along.

Device half of the JAX package's ``linalg/multifrontal.py`` (``mf_factor``)
for the likelihood, in the augmented-RHS formulation on every level.  The
right-hand side b = sum_e rhs_elem[e] u_e + rhs_vert is front row/column
F1-1, so after the partial factor of a front its row F1-1 holds
y = L_pp^{-1} b (quad = sum y^2) and its trailing block is the augmented
Schur update the parent extend-adds.  Each level is

    leaf:      H2 leaf_assemble  -> H4 front_factor
    internal:  H3 extend_add     -> H4 front_factor

``mf_factor`` is one ``torch.autograd.Function`` (the same code on CPU and
CUDA).  Without gradients a level's front is released as soon as its parent
is assembled.  With gradients every level's factored front is kept, and the
backward walks the levels root -> leaf:

    seed the front's cotangent from (logdet, quad) -> front_factor_vjp
    -> H6 extend_add_bwd into the children's Schur blocks (internal)
       or H7 leaf_assemble_bwd (leaf) -> scatter d dvec, d rhs_vert

writing each child's Schur-block cotangent into that child's saved front
(its [P:, P:] block, which the backward does not otherwise read), so no
separate child cotangent is allocated.

For the posterior, ``mf_factor_keep`` runs the same forward without
gradients and returns the factored fronts as an ``MFFactor``; on it
``mf_forward`` / ``mf_backward`` / ``mf_solve`` solve with W and
``mf_selinv_diag`` gives diag(W^{-1}) by the top-down selected inverse
(the JAX package's functions of those names, XLA there: here plain torch
triangular solves, batched products and gathers).  They read only the lower
triangles of the fronts: H4 never writes the upper ones.
"""

from __future__ import annotations

import numpy as np
import torch

from torch.autograd.function import once_differentiable

from .frontal import (extend_add, extend_add_bwd, front_factor,
                      front_factor_vjp, leaf_assemble, leaf_assemble_bwd)

__all__ = ["MFFactor", "mf_device_arrays", "mf_factor", "mf_factor_keep",
           "mf_forward", "mf_backward", "mf_solve", "mf_selinv_diag"]


class MFLevels(list):
    """Per-level index tensors of an ``MFPlan`` (root first, leaf last) and
    the plan's flat x layout: ``x_size`` slots, ``x_slot`` (n_vert,) the
    slot of each vertex, each level's first slot as its ``x_off``."""

    def __init__(self, levels, n_vert, x_size, x_slot):
        super().__init__(levels)
        self.n_vert, self.x_size, self.x_slot = n_vert, x_size, x_slot


def mf_device_arrays(mf, device):
    """Per-level index tensors of an ``MFPlan`` (an ``MFLevels``)."""
    levels = []
    D = mf.depth
    for d, lv in enumerate(mf.levels):
        P, B = lv.npiv, lv.nbord
        F1 = P + B + 1
        N = lv.piv_ids.shape[0]
        entry = dict(P=P, B=B, F1=F1, x_off=int(mf.x_offsets[d]),
                     piv_ids=torch.as_tensor(lv.piv_ids).long().to(device))
        if d > 0:
            entry["bip"] = torch.as_tensor(lv.bord_in_parent).long().to(device)
            entry["bxs"] = torch.as_tensor(lv.bord_x_slot).long().to(device)
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
    return MFLevels(levels, mf.n_vert, mf.x_size,
                    torch.as_tensor(mf.x_slot).long().to(device))


def _piv_vec(piv_ids, vec, fill, F1):
    """(N, F1): vec at the pivot ids (padded pivots -> fill), 0 elsewhere."""
    N, P = piv_ids.shape
    ok = piv_ids >= 0
    v = torch.where(ok, vec[piv_ids.clamp(min=0)], fill)
    return torch.cat([v, vec.new_zeros(N, F1 - P)], dim=1)


# bytes of one front-sized (chunk, F1, F1) temporary of the backward: a
# level's pullback holds about eight at once, so ~4 GB per chunk
_BWD_CHUNK_BYTES = 1 << 29


def _forward(levels, u_elem, dvec, rhs_elem, rhs_vert, keep):
    """(logdet, quad, fronts): fronts[d] is level d's factored front when
    ``keep``, else None (released once its parent is assembled)."""
    dt = u_elem.dtype
    logdet = u_elem.new_zeros(())
    quad = u_elem.new_zeros(())
    fronts = [None] * len(levels)
    child = None
    for d in range(len(levels) - 1, -1, -1):
        lv = levels[d]
        P, F1 = lv["P"], lv["F1"]
        dv = _piv_vec(lv["piv_ids"], dvec, 1.0, F1).to(dt)
        rv = _piv_vec(lv["piv_ids"], rhs_vert, 0.0, F1).to(dt)
        if child is None:
            u, re = _leaf_values(lv["elem_pt"], u_elem, rhs_elem)
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
        if keep:
            fronts[d] = front
    return logdet, quad, fronts


def _leaf_values(ept, u_elem, rhs_elem):
    """(u (N, EL, K), re (N, EL)): the values of the leaf elements ``ept``
    (N, EL), 0 at pads."""
    ok = ept >= 0
    ec = ept.clamp(min=0)
    return (torch.where(ok[..., None], u_elem[ec], 0.0),
            torch.where(ok, rhs_elem[ec], 0.0))


def _scatter(acc, ids, vals):
    """acc[ids] += vals where ids >= 0 (pads add an exact 0 at id 0: no
    boolean indexing, so no host synchronization)."""
    ok = ids >= 0
    vals = torch.where(ok.reshape(ok.shape + (1,) * (vals.dim() - ok.dim())),
                       vals, 0.0)
    acc.index_add_(0, ids.clamp(min=0).reshape(-1),
                   vals.reshape((-1,) + acc.shape[1:]))


def _backward(levels, fronts, u_elem, rhs_elem, n_vert, g_logdet, g_quad):
    du_elem = torch.zeros_like(u_elem)
    drhs_elem = torch.zeros_like(rhs_elem)
    ddvec = u_elem.new_zeros(n_vert)
    drhs_vert = u_elem.new_zeros(n_vert)
    g_logdet = g_logdet.to(u_elem.dtype)
    g_quad = g_quad.to(u_elem.dtype)
    D = len(levels) - 1
    for d, lv in enumerate(levels):
        front = fronts[d]
        P, F1 = lv["P"], lv["F1"]
        N, B1 = front.shape[0], F1 - P
        # the root's Schur block feeds nothing; below it, the parent's H6
        # wrote this level's Schur-block cotangent into [P:, P:]
        dupd = front[:, P:, P:] if d > 0 else None
        if d < D:
            Pc = levels[d + 1]["P"]
            child_blk = fronts[d + 1][:, Pc:, Pc:]
            child_blk.zero_()
            child_blk = child_blk.unflatten(0, (-1, 2))
        step = max(1, _BWD_CHUNK_BYTES // (F1 * F1 * front.element_size()))
        for n0 in range(0, N, step):
            sl = slice(n0, n0 + step)
            fr = front[sl]
            L_diag = torch.diagonal(fr[:, :P, :P], 0, 1, 2)
            dL_pp = torch.diag_embed(2.0 * g_logdet / L_diag)
            dL_bp = fr.new_zeros(fr.shape[0], B1, P)
            dL_bp[:, B1 - 1] = 2.0 * g_quad * fr[:, F1 - 1, :P]
            dfront = front_factor_vjp(fr, P, dL_pp, dL_bp,
                                      None if dupd is None else dupd[sl])
            del dL_pp, dL_bp
            if d < D:
                ddv, drv = extend_add_bwd(dfront, lv["ext_aug"][sl],
                                          child_blk[sl])
            else:
                ept = lv["elem_pt"][sl]
                u, re = _leaf_values(ept, u_elem, rhs_elem)
                du, dre, ddv, drv = leaf_assemble_bwd(
                    dfront, u, lv["elem_pos"][sl], re)
                _scatter(du_elem, ept, du)
                _scatter(drhs_elem, ept, dre)
                del u, re, du, dre
            del dfront
            _scatter(ddvec, lv["piv_ids"][sl], ddv[:, :P])
            _scatter(drhs_vert, lv["piv_ids"][sl], drv[:, :P])
    return du_elem, ddvec, drhs_elem, drhs_vert


class _MFFactor(torch.autograd.Function):

    @staticmethod
    def forward(ctx, levels, u_elem, dvec, rhs_elem, rhs_vert):
        keep = any(ctx.needs_input_grad[1:])
        logdet, quad, fronts = _forward(levels, u_elem, dvec, rhs_elem,
                                        rhs_vert, keep)
        if keep:
            ctx.levels = levels
            ctx.dtypes = (dvec.dtype, rhs_vert.dtype)
            ctx.n_vert = dvec.shape[0]
            ctx.save_for_backward(u_elem, rhs_elem, *fronts)
        return logdet, quad

    @staticmethod
    @once_differentiable
    def backward(ctx, g_logdet, g_quad):
        u_elem, rhs_elem, *fronts = ctx.saved_tensors
        # The backward writes each child's Schur-block cotangent into that
        # child's saved front ([P:, P:], which nothing else of the backward
        # reads), so it works on aliases outside autograd's version
        # tracking; a second backward (retain_graph) rewrites the same
        # blocks the same way.
        du, ddvec, dre, drv = _backward(ctx.levels, [f.data for f in fronts],
                                        u_elem, rhs_elem, ctx.n_vert,
                                        g_logdet, g_quad)
        return (None, du, ddvec.to(ctx.dtypes[0]), dre,
                drv.to(ctx.dtypes[1]))


def mf_factor(levels, u_elem, dvec, rhs_elem, rhs_vert):
    """(logdet W, b^T W^{-1} b) for W = sum_e u_e u_e^T + diag(dvec),
    differentiable in all four inputs.

    u_elem: (E, K) element values aligned with the plan's element vertices
    (0 at absent slots); dvec, rhs_vert: (n_vert,); rhs_elem: (E,).
    Padded pivots get 1.0 on the diagonal and factor as exact 1s.
    """
    return _MFFactor.apply(levels, u_elem, dvec, rhs_elem, rhs_vert)


# ------------------------------------------------------- the posterior ----

class MFFactor:
    """A kept multifrontal factor of W (what the JAX package's ``fac`` dict
    holds): ``logdet`` = log det W, ``quad`` = b^T W^{-1} b, and each level's
    factored front (N, F1, F1), whose lower triangle holds L_pp in
    [:P, :P], L_bp in [P:F1-1, :P] and y = L_pp^{-1} b in row F1-1.  The
    upper triangles are unspecified (H4 never writes them), so the
    accessors and every solve read lower triangles only."""

    def __init__(self, levels, fronts, logdet, quad):
        self.levels, self.fronts = levels, fronts
        self.logdet, self.quad = logdet, quad

    @property
    def dtype(self):
        return self.fronts[0].dtype

    @property
    def device(self):
        return self.fronts[0].device

    @property
    def n_vert(self):
        return self.levels.n_vert

    def _lpp(self, d):
        """Level d's L_pp as a view of its fronts (upper triangle unset)."""
        P = self.levels[d]["P"]
        return self.fronts[d][:, :P, :P]

    def L_pp(self, d):
        return torch.tril(self._lpp(d))

    def L_bp(self, d):
        lv = self.levels[d]
        return self.fronts[d][:, lv["P"]:lv["F1"] - 1, :lv["P"]]

    def y(self, d):
        lv = self.levels[d]
        return self.fronts[d][:, lv["F1"] - 1, :lv["P"]]


def mf_factor_keep(levels, u_elem, dvec, rhs_elem, rhs_vert):
    """``mf_factor``'s forward, not differentiable, returning the factor
    (an ``MFFactor``) for the solves and the selected inverse below."""
    with torch.no_grad():
        logdet, quad, fronts = _forward(levels, u_elem, dvec, rhs_elem,
                                        rhs_vert, keep=True)
    return MFFactor(levels, fronts, logdet, quad)


def mf_forward(fac, rhs_vert):
    """Forward solve L y = b for a fresh RHS b = rhs_vert over the vertices,
    (n_vert,) or (n_vert, k), with a kept factor.  Returns (ys, quad): the
    per-level pivot solutions (N, P) (or (N, P, k)) and ||y||^2."""
    levels = fac.levels
    rhs = rhs_vert.to(fac.device, fac.dtype)
    vec = rhs.dim() == 1
    rhs = rhs[:, None] if vec else rhs
    k = rhs.shape[1]
    ys = [None] * len(levels)
    quad = rhs.new_zeros(())
    bupd = None
    for d in range(len(levels) - 1, -1, -1):
        lv = levels[d]
        P, F = lv["P"], lv["F1"] - 1
        piv = lv["piv_ids"]
        N = piv.shape[0]
        b = rhs.new_zeros(N, F, k)
        b[:, :P] = torch.where((piv >= 0)[..., None], rhs[piv.clamp(min=0)],
                               0.0)
        if bupd is not None and bupd.shape[1] > 0:
            # extend-add the children's border vectors (``_extend_add_vec``)
            bc = bupd.unflatten(0, (N, 2))
            for s in (0, 1):
                g = lv["ext_aug"][:, s, :F].long()
                vb = torch.gather(bc[:, s], 1,
                                  g.clamp(min=0)[..., None].expand(-1, -1, k))
                b += torch.where((g >= 0)[..., None], vb, 0.0)
        y = torch.linalg.solve_triangular(fac._lpp(d), b[:, :P], upper=False)
        ys[d] = y[..., 0] if vec else y
        quad = quad + torch.sum(y * y)
        bupd = b[:, P:] - fac.L_bp(d) @ y
    return ys, quad


def mf_backward(fac, ys=None):
    """Back-substitution L^T x = y, root -> leaf; x over the vertices.
    ``ys`` defaults to the factor's own y (x = W^{-1} b)."""
    levels = fac.levels
    if ys is None:
        ys = [fac.y(d)[..., None] for d in range(len(levels))]
        vec = True
    else:
        vec = ys[0].dim() == 2
        ys = [y[..., None] for y in ys] if vec else ys
    k = ys[0].shape[-1]
    x = ys[0].new_zeros(levels.x_size, k)
    for d, lv in enumerate(levels):
        P, F = lv["P"], lv["F1"] - 1
        if P == 0:
            continue
        rhs = ys[d]
        if d > 0 and F > P:
            bxs = lv["bxs"]
            xb = torch.where((bxs >= 0)[..., None], x[bxs.clamp(min=0)], 0.0)
            rhs = rhs - fac.L_bp(d).mT @ xb
        xp = torch.linalg.solve_triangular(fac._lpp(d).mT, rhs, upper=True)
        x[lv["x_off"]:lv["x_off"] + xp.shape[0] * P] = xp.reshape(-1, k)
    x = x[levels.x_slot]
    return x[:, 0] if vec else x


def mf_solve(fac, rhs_vert):
    """x = W^{-1} rhs_vert with a kept factor; rhs (n_vert,) or (n_vert, k)."""
    ys, _ = mf_forward(fac, rhs_vert)
    return mf_backward(fac, ys)


def _tri_inv(L):
    """L^{-1} of lower-triangular (N, P, P) matrices (upper triangle
    unread)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def _sbb_from_parent(S_prev, par, bip):
    """(N, B, B): the parent's selected-inverse front at the border
    positions ``bip`` (pads -> 0)."""
    ok = bip >= 0
    gc = bip.clamp(min=0)
    S = S_prev[par[:, None, None], gc[:, :, None], gc[:, None, :]]
    return torch.where(ok[:, :, None] & ok[:, None, :], S, 0.0)


def _leaf_diag(front, P, F, bip, par, S_prev):
    """Pivot diagonal of the selected inverse of fronts that have no
    children: diag(L_pp^{-T} L_pp^{-1}) + diag(G^T S_bb G)."""
    Linv = _tri_inv(front[:, :P, :P])
    G = front[:, P:F, :P] @ Linv
    t = _sbb_from_parent(S_prev, par, bip) @ G
    return torch.sum(Linv * Linv, dim=1) + torch.sum(G * t, dim=1)


# bytes of the leaf's (N, F, F) selected-inverse fronts above which the
# leaf is taken in node chunks (the JAX package's rule)
_LEAF_CHUNK_BYTES = 400_000_000


def mf_selinv_diag(fac, leaf_chunks=None):
    """diag(W^{-1}) over the vertices by the top-down multifrontal selected
    inverse (the Takahashi recursion), with G = L_bp L_pp^{-1} and S_bb
    gathered from the parent's selected-inverse front:

        S_bp = -S_bb G,    S_pp = L_pp^{-T} L_pp^{-1} + G^T S_bb G.

    Exact here (the fronts carry the full fill).  Only the parent's front
    S is kept alive; the deepest level computes its pivot diagonal alone,
    in node chunks (``leaf_chunks``, else as many as keep a chunk's
    (C, F, F) under 400 MB), so no leaf selected-inverse front is built."""
    levels = fac.levels
    D = len(levels) - 1
    n_vert = levels.n_vert
    diag = fac.fronts[0].new_zeros(n_vert + 1)       # the last slot: pads
    S_prev = None
    for d, lv in enumerate(levels):
        P, F = lv["P"], lv["F1"] - 1
        front = fac.fronts[d]
        N = front.shape[0]
        par = torch.arange(N, device=front.device) // 2
        if d == D and F > P and d > 0:
            nchunk = leaf_chunks
            if nchunk is None:
                nchunk = 1
                while (N * F * F * front.element_size() // nchunk
                       > _LEAF_CHUNK_BYTES and nchunk < N):
                    nchunk *= 2
            step = -(-N // nchunk)
            dg = torch.cat([
                _leaf_diag(front[s:s + step], P, F, lv["bip"][s:s + step],
                           par[s:s + step], S_prev)
                for s in range(0, N, step)])
        else:
            # the level's selected-inverse front, written block by block
            Linv = _tri_inv(front[:, :P, :P])
            S = front.new_empty(N, F, F)
            S_pp = S[:, :P, :P]
            S_pp.copy_(Linv.mT @ Linv)
            if F > P:
                S_bb, S_bp = S[:, P:, P:], S[:, P:, :P]
                S_bb.copy_(_sbb_from_parent(S_prev, par, lv["bip"]))
                G = front[:, P:F, :P] @ Linv
                S_bp.copy_(S_bb @ G).neg_()
                S_pp -= G.mT @ S_bp
                S[:, :P, P:] = S_bp.mT
                del G
            del Linv
            dg = torch.diagonal(S_pp, 0, 1, 2)
            S_prev = S
        piv = lv["piv_ids"]
        diag.index_put_((torch.where(piv >= 0, piv, n_vert).reshape(-1),),
                        dg.reshape(-1))
    return diag[:n_vert]
