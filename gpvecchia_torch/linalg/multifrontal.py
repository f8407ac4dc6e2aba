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

    H9 front_factor_bwd: the front's cotangent, in place of its factor
    -> H6 extend_add_bwd into the children's Schur blocks (internal)
       or H7 leaf_assemble_bwd (leaf) -> scatter d dvec, d rhs_vert

writing each child's Schur-block cotangent into the lower triangle of that
child's saved front's [P:, P:] block, where H9 reads it, so no front-sized
cotangent is allocated.  On the card the backward consumes the saved
fronts (a second backward over the graph raises); on the CPU it works on
a copy of each level.

For the posterior, ``mf_factor_keep`` runs the same forward without
gradients and returns the factored fronts as an ``MFFactor``; on it
``mf_forward`` / ``mf_backward`` / ``mf_solve`` solve with W and
``mf_selinv_diag`` gives diag(W^{-1}) by the top-down selected inverse
(the JAX package's functions of those names, XLA there: here plain torch
triangular solves, batched products and gathers).  They read only the lower
triangles of the fronts: H4 never writes the upper ones.

A rank of a sharded run (``parallel/mesh.py``) holds a share of the tree
(``mf_device_arrays(mf, device, ranks, rank)``): from the shallowest depth
whose node count the rank count divides (log2 R) down to the leaves, the
contiguous node range [r N/R, (r+1) N/R) of every level, which is a whole
set of subtrees, since the children of node i are 2i and 2i+1; above that,
the replicated top levels (``levels.top``), which every rank computes.
``mf_factor_part`` factors either part: the share's own levels return
their shallowest level's Schur blocks, which the ranks exchange, and the
top levels extend-add from the exchanged blocks.  ``mf_factor_keep``,
``mf_backward`` and ``mf_selinv_diag`` take the same walk (top down in
the last two) and exchange their vertex results at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from torch.autograd.function import once_differentiable

from ..utils import trace
from .frontal import (_sym_lower, extend_add, extend_add_bwd, front_factor,
                      front_factor_bwd, leaf_assemble, leaf_assemble_bwd)

__all__ = ["MFFactor", "mf_device_arrays", "mf_factor", "mf_factor_part",
           "mf_factor_keep", "mf_forward", "mf_backward", "mf_solve",
           "mf_selinv_diag"]


class MFLevels(list):
    """Per-level index tensors of an ``MFPlan`` (root first, leaf last) and
    the plan's flat x layout: ``x_size`` slots, ``x_slot`` (n_vert,) the
    slot of each vertex, each level's first slot as its ``x_off``.

    On a rank's share the list holds its own levels only (the shallowest
    sharded depth first) and ``top`` the replicated levels above them
    (None when the rank holds the whole tree); ``elems`` are the element
    ids (rows) of its leaves, sorted, to which the leaf's ``elem_pt``
    points (None: every element, unmapped), and ``x_top`` is the first
    slot past the top levels' pivots."""

    def __init__(self, levels, n_vert, x_size, x_slot, top=None, elems=None,
                 x_top=0):
        super().__init__(levels)
        self.n_vert, self.x_size, self.x_slot = n_vert, x_size, x_slot
        self.top, self.elems, self.x_top = top, elems, x_top


def mf_device_arrays(mf, device, ranks=1, rank=0):
    """Per-level index tensors of an ``MFPlan`` (an ``MFLevels``): the
    whole tree, or rank ``rank``'s share of it among ``ranks``.

    ``ranks`` must be a power of two no larger than the number of leaves:
    every depth d >= log2(ranks) then splits into equal node ranges, and
    the log2(ranks) levels above are replicated.  Any other rank count
    raises ``ValueError`` (the JAX package replicates a level whose node
    count does not divide; here a rank count that splits no level would
    leave every rank the whole factor)."""
    if ranks < 1 or ranks & (ranks - 1):
        raise ValueError(f"the multifrontal tree splits over a power of two "
                         f"of ranks, not {ranks}")
    D = mf.depth
    if (1 << D) < ranks:
        raise ValueError(f"the multifrontal tree has {1 << D} leaves, fewer "
                         f"than the {ranks} ranks to split it over")
    s = ranks.bit_length() - 1            # the shallowest sharded depth

    def own_range(d):
        N = 1 << d
        return (rank * N // ranks, (rank + 1) * N // ranks) if d >= s \
            else (0, N)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    levels, elems = [], None
    for d, lv in enumerate(mf.levels):
        P, B = lv.npiv, lv.nbord
        F1 = P + B + 1
        n0, n1 = own_range(d)
        N = n1 - n0
        entry = dict(P=P, B=B, F1=F1, x_off=int(mf.x_offsets[d]) + n0 * P,
                     piv_ids=t(lv.piv_ids[n0:n1]).long())
        if d > 0:
            entry["bip"] = t(lv.bord_in_parent[n0:n1]).long()
            entry["bxs"] = t(lv.bord_x_slot[n0:n1]).long()
            # the parent of node i is node i // 2, indexed within the
            # parent level's own range
            entry["par"] = t(np.arange(n0, n1) // 2 - own_range(d - 1)[0])
        if d < D:
            Bc1 = mf.levels[d + 1].nbord + 1
            ext_aug = np.full((N, 2, F1), -1, np.int32)
            ext_aug[:, :, :F1 - 1] = lv.ext[n0:n1]
            ext_aug[:, :, F1 - 1] = Bc1 - 1
            entry["ext_aug"] = t(ext_aug)
        else:
            ept = lv.elem_pt[n0:n1]
            if ranks > 1:
                elems = np.unique(ept[ept >= 0])
                ept = np.where(ept >= 0, np.searchsorted(elems, ept), -1)
            entry["elem_pt"] = t(ept).long()
            entry["elem_pos"] = t(lv.elem_pos[n0:n1])
        levels.append(entry)
    x_slot = t(mf.x_slot).long()
    if s == 0:
        return MFLevels(levels, mf.n_vert, mf.x_size, x_slot)
    top = MFLevels(levels[:s], mf.n_vert, mf.x_size, x_slot)
    return MFLevels(levels[s:], mf.n_vert, mf.x_size, x_slot, top=top,
                    elems=elems, x_top=int(mf.x_offsets[s]))


def _piv_vec(piv_ids, vec, fill, F1):
    """(N, F1): vec at the pivot ids (padded pivots -> fill), 0 elsewhere."""
    N, P = piv_ids.shape
    ok = piv_ids >= 0
    v = torch.where(ok, vec[piv_ids.clamp(min=0)], fill)
    return torch.cat([v, vec.new_zeros(N, F1 - P)], dim=1)


@trace.span("mf.fwd")
def _forward(levels, first, dvec, rhs_elem, rhs_vert, keep):
    """(logdet, quad, fronts, schur) over ``levels``: fronts[d] is level
    d's factored front when ``keep``, else None (released once its parent
    is assembled); ``schur`` the first level's Schur blocks, a view.

    ``first`` is the element values u_elem (E, K) when the deepest level
    is the leaf, else the Schur blocks (2N, B+1, B+1) of the level below
    the deepest (the exchanged blocks of a share's top levels)."""
    dt = first.dtype
    logdet = first.new_zeros(())
    quad = first.new_zeros(())
    fronts = [None] * len(levels)
    blk = None if "elem_pt" in levels[-1] else first
    depth0 = _depth0(levels)
    for d in range(len(levels) - 1, -1, -1):
        lv = levels[d]
        P, F1 = lv["P"], lv["F1"]
        with trace.span(f"mf.fwd.d{depth0 + d}"):
            dv = _piv_vec(lv["piv_ids"], dvec, 1.0, F1).to(dt)
            rv = _piv_vec(lv["piv_ids"], rhs_vert, 0.0, F1).to(dt)
            if blk is None:
                u, re = _leaf_values(lv["elem_pt"], first, rhs_elem)
                front = leaf_assemble(u, lv["elem_pos"], re, dv, rv)
                del u, re
            else:
                # the children's Schur blocks, read in place from their
                # fronts
                front = extend_add(blk.unflatten(0, (-1, 2)), lv["ext_aug"],
                                   dv, rv)
            blk = None
            front_factor(front, P)
            diag = torch.diagonal(front, dim1=1, dim2=2)[:, :P]
            logdet = logdet + 2.0 * torch.sum(torch.log(diag))
            y = front[:, F1 - 1, :P]
            quad = quad + torch.sum(y * y)
            blk = front[:, P:, P:]
        if keep:
            fronts[d] = front
    return logdet, quad, fronts, blk


def _depth0(levels):
    """The tree depth of ``levels[0]``: 0 for the whole tree or a share's
    top levels, the number of top levels for a share's own levels."""
    return 0 if levels.top is None else len(levels.top)


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


@trace.span("mf.bwd")
def _backward(levels, fronts, u_elem, rhs_elem, n_vert, g_logdet, g_quad,
              g_schur=None, d_first=None, consume=True):
    """Cotangents of ``_forward``'s inputs: (du_elem, ddvec, drhs_elem,
    drhs_vert), the first and third None when the deepest level is not the
    leaf; then the cotangent of the blocks below it is written into
    ``d_first`` (zeros, the blocks' shape) as full symmetric blocks.
    ``g_schur`` is the cotangent of the first level's Schur blocks (None:
    nothing reads them).  ``consume``: each level's cotangent overwrites
    its saved front (else a copy of the level's fronts)."""
    leaf = "elem_pt" in levels[-1]
    du_elem = torch.zeros_like(u_elem) if leaf else None
    drhs_elem = torch.zeros_like(rhs_elem) if leaf else None
    ddvec = fronts[0].new_zeros(n_vert)
    drhs_vert = fronts[0].new_zeros(n_vert)
    D = len(levels) - 1
    depth0 = _depth0(levels)
    for d, lv in enumerate(levels):
        with trace.span(f"mf.bwd.d{depth0 + d}"):
            front = fronts[d] if consume else fronts[d].clone()
            P = lv["P"]
            if d == 0:
                # the first level's Schur block feeds the exchange (or
                # nothing, at the root); below it, the parent's H6 wrote this
                # level's Schur-block cotangent into [P:, P:]
                blk = front[:, P:, P:]
                if g_schur is None:
                    blk.zero_()
                else:
                    blk.copy_(0.5 * (g_schur + g_schur.mT))
            front_factor_bwd(front, P, g_logdet, g_quad)
            if d < D:
                Pc = levels[d + 1]["P"]
                child_blk = fronts[d + 1][:, Pc:, Pc:]
                child_blk.zero_()
                ddv, drv = extend_add_bwd(front, lv["ext_aug"],
                                          child_blk.unflatten(0, (-1, 2)))
            elif not leaf:
                ddv, drv = extend_add_bwd(front, lv["ext_aug"],
                                          d_first.unflatten(0, (-1, 2)))
                # H6 adds into lower triangles (H3 read those of the
                # exchanged blocks): the full symmetric blocks
                d_first.copy_(_sym_lower(d_first))
            else:
                ept = lv["elem_pt"]
                u, re = _leaf_values(ept, u_elem, rhs_elem)
                du, dre, ddv, drv = leaf_assemble_bwd(front, u,
                                                      lv["elem_pos"], re)
                _scatter(du_elem, ept, du)
                _scatter(drhs_elem, ept, dre)
                del u, re, du, dre
            del front
            _scatter(ddvec, lv["piv_ids"], ddv[:, :P])
            _scatter(drhs_vert, lv["piv_ids"], drv[:, :P])
    return du_elem, ddvec, drhs_elem, drhs_vert


class _MFFactor(torch.autograd.Function):

    @staticmethod
    def forward(ctx, levels, first, dvec, rhs_elem, rhs_vert):
        keep = any(ctx.needs_input_grad[1:])
        logdet, quad, fronts, blk = _forward(levels, first, dvec, rhs_elem,
                                             rhs_vert, keep)
        if levels.top is None:
            schur = first.new_zeros(0)
            ctx.mark_non_differentiable(schur)
        else:
            schur = blk.clone(memory_format=torch.contiguous_format)
        del blk
        if keep:
            ctx.levels = levels
            ctx.dtypes = (dvec.dtype, rhs_vert.dtype)
            ctx.n_vert = dvec.shape[0]
            ctx.first_shape = first.shape
            leaf_in = (first, rhs_elem) if "elem_pt" in levels[-1] else ()
            ctx.n_leaf_in = len(leaf_in)
            ctx.save_for_backward(*leaf_in, *fronts)
            ctx.consumed = False
        return logdet, quad, schur

    @staticmethod
    @once_differentiable
    def backward(ctx, g_logdet, g_quad, g_schur):
        if ctx.consumed:
            raise RuntimeError(
                "mf_factor: the first backward on the card overwrote the "
                "saved fronts with their cotangents; a second backward over "
                "the same graph (retain_graph=True) is not supported there")
        saved = ctx.saved_tensors
        u_elem, rhs_elem = saved[:ctx.n_leaf_in] or (None, None)
        fronts = [f.data for f in saved[ctx.n_leaf_in:]]
        d_first = None
        if u_elem is None:
            d_first = fronts[0].new_zeros(ctx.first_shape)
        # The backward writes each child's Schur-block cotangent into that
        # child's saved front ([P:, P:]), and on the card H9 overwrites
        # each front with its cotangent, so it works on aliases outside
        # autograd's version tracking.  On the CPU each level's fronts are
        # copied first and the child blocks rewritten the same way, so a
        # second backward (retain_graph, as gradcheck runs) gives the same.
        consume = fronts[0].device.type == "cuda"
        ctx.consumed = consume
        du, ddvec, dre, drv = _backward(
            ctx.levels, fronts, u_elem, rhs_elem, ctx.n_vert, g_logdet,
            g_quad, g_schur if g_schur.numel() else None, d_first, consume)
        return (None, du if u_elem is not None else d_first,
                ddvec.to(ctx.dtypes[0]), dre, drv.to(ctx.dtypes[1]))


def mf_factor_part(levels, first, dvec, rhs_elem, rhs_vert):
    """(logdet, quad, schur) of the factor over ``levels``, differentiable
    in its inputs: on the whole tree or a rank's own levels ``first`` is
    u_elem and the element RHS ``rhs_elem``, on a share's top levels
    (``levels.top`` of the own part) ``first`` is the exchanged Schur
    blocks of the depth below and ``rhs_elem`` None.  ``schur`` is the own
    part's shallowest Schur blocks (N_own, B+1, B+1), contiguous, for the
    exchange; empty where nothing lies above."""
    return _MFFactor.apply(levels, first, dvec, rhs_elem, rhs_vert)


def mf_factor(levels, u_elem, dvec, rhs_elem, rhs_vert):
    """(logdet W, b^T W^{-1} b) for W = sum_e u_e u_e^T + diag(dvec),
    differentiable in all four inputs.

    u_elem: (E, K) element values aligned with the plan's element vertices
    (0 at absent slots); dvec, rhs_vert: (n_vert,); rhs_elem: (E,).
    Padded pivots get 1.0 on the diagonal and factor as exact 1s.
    """
    return mf_factor_part(levels, u_elem, dvec, rhs_elem, rhs_vert)[:2]


# ------------------------------------------------------- the posterior ----

class MFFactor:
    """A kept multifrontal factor of W (what the JAX package's ``fac`` dict
    holds): ``logdet`` = log det W, ``quad`` = b^T W^{-1} b, and each level's
    factored front (N, F1, F1), whose lower triangle holds L_pp in
    [:P, :P], L_bp in [P:F1-1, :P] and y = L_pp^{-1} b in row F1-1.  The
    upper triangles are unspecified (H4 never writes them), so the
    accessors and every solve read lower triangles only.

    A sharded factor lists the replicated top levels first (``n_top`` of
    them) and then the rank's own levels, with ``share`` the exchange of
    the solves' results."""

    def __init__(self, levels, fronts, logdet, quad, share=None, n_top=0):
        self.levels, self.fronts = levels, fronts
        self.logdet, self.quad = logdet, quad
        self.share, self.n_top = share, n_top

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


def mf_factor_keep(levels, u_elem, dvec, rhs_elem, rhs_vert, share=None):
    """``mf_factor``'s forward, not differentiable, returning the factor
    (an ``MFFactor``) for the solves and the selected inverse below.  On a
    rank's share of the tree, ``share`` (``parallel.mesh.RowShare``)
    exchanges the own levels' shallowest Schur blocks, and every rank
    factors the top levels; ``logdet`` and ``quad`` are the whole tree's."""
    with torch.no_grad():
        logdet, quad, fronts, blk = _forward(levels, u_elem, dvec, rhs_elem,
                                             rhs_vert, keep=True)
        top = levels.top
        if top is None:
            return MFFactor(levels, fronts, logdet, quad)
        logdet, quad = share.reduce(logdet, quad)
        upd = share.all_gather(
            blk.clone(memory_format=torch.contiguous_format))
        del blk
        ld, q, top_fronts, _ = _forward(top, upd, dvec, None, rhs_vert,
                                        keep=True)
        del upd
    both = MFLevels(list(top) + list(levels), levels.n_vert, levels.x_size,
                    levels.x_slot, x_top=levels.x_top)
    return MFFactor(both, top_fronts + fronts, logdet + ld, quad + q,
                    share=share, n_top=len(top))


def mf_forward(fac, rhs_vert):
    """Forward solve L y = b for a fresh RHS b = rhs_vert over the vertices,
    (n_vert,) or (n_vert, k), with a kept factor.  Returns (ys, quad): the
    per-level pivot solutions (N, P) (or (N, P, k)) and ||y||^2."""
    if fac.share is not None:
        raise NotImplementedError("mf_forward on a sharded factor")
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
    if fac.share is not None:
        # every rank's own slots (past the top levels' x_top) to every rank
        own = x.clone()
        own[:levels.x_top] = 0.0
        own = fac.share.all_sum(own)
        own[:levels.x_top] = x[:levels.x_top]
        x = own
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
    top = []
    S_prev = None
    for d, lv in enumerate(levels):
        P, F = lv["P"], lv["F1"] - 1
        front = fac.fronts[d]
        N = front.shape[0]
        par = lv.get("par")
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
        at = (torch.where(piv >= 0, piv, n_vert).reshape(-1), dg.reshape(-1))
        if d < fac.n_top:
            top.append(at)
        else:
            diag.index_put_((at[0],), at[1])
    if fac.share is not None:
        # every rank's own vertices to every rank, then the top's
        diag = fac.share.all_sum(diag)
        for idx, v in top:
            diag.index_put_((idx,), v)
    return diag[:n_vert]
