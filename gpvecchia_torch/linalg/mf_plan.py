"""Host-side multifrontal planner (NumPy, parameter-free, run once per spec).

A jax-free copy of the JAX package's planner (``linalg/multifrontal.py``
``build_mf_plan``): elements (one per Vecchia U column) are split into a
balanced binary spatial tree by median cuts, each vertex is assigned to the
lowest common ancestor of the leaves whose elements touch it, and every tree
level gets padded (N, P) pivot lists, (N, B) borders, the child->parent
extend-add maps ``ext`` and, at the leaves, the element maps.  The port's
tests hold its arrays equal to the JAX planner's, array for array.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import trace

__all__ = ["MFLevel", "MFPlan", "build_mf_plan"]

@dataclasses.dataclass
class MFLevel:
    """Padded per-depth node arrays (N = 2**depth nodes at this depth)."""
    npiv: int                    # P: padded pivot count per node
    nbord: int                   # B: padded border count per node
    piv_ids: np.ndarray          # (N, P) int32 vertex ids, -1 pad
    ext: np.ndarray | None       # (N, 2, F) parent-front pos -> child border pos
    bord_in_parent: np.ndarray | None  # (N, B) border pos -> parent front pos
    bord_x_slot: np.ndarray | None     # (N, B) flat x slot of border verts
    elem_pt: np.ndarray | None   # leaves only: (N, EL) element ids, -1 pad
    elem_pos: np.ndarray | None  # leaves only: (N, EL, K) front positions, -1

    @property
    def front(self):
        return self.npiv + self.nbord


@dataclasses.dataclass
class MFPlan:
    n_vert: int
    depth: int                   # leaves at depth D, root at 0
    levels: list                 # MFLevel, indexed by depth 0..D
    x_offsets: np.ndarray        # (D+1,) flat x offset of each level's pivots
    x_size: int
    x_slot: np.ndarray           # (n_vert,) flat x slot of each vertex (unique)


def _median_split_tree(xy, depth):
    """Leaf index (in-order, 0..2**depth-1) per element via median splits."""
    E = xy.shape[0]
    leaf = np.zeros(E, dtype=np.int64)
    if depth == 0:
        return leaf

    def rec(ids, d, node):
        if d == depth:
            leaf[ids] = node
            return
        sub = xy[ids]
        dim = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
        order = np.argsort(sub[:, dim], kind="stable")
        h = ids.size // 2
        rec(ids[order[:h]], d + 1, node * 2)
        rec(ids[order[h:]], d + 1, node * 2 + 1)

    rec(np.arange(E), 0, 0)
    return leaf


@trace.span("plan.mf")
def build_mf_plan(elem_verts, elem_xy, n_vert, leaf_elems=96,
                  max_depth=None) -> MFPlan:
    """Build the multifrontal plan.

    elem_verts: (E, K) int vertex ids per element, -1 padded.
    elem_xy:    (E, d) element locations (used only for partitioning).
    Every vertex in [0, n_vert) must appear in at least one element.
    """
    elem_verts = np.asarray(elem_verts, dtype=np.int64)
    E, K = elem_verts.shape
    D = max(int(np.ceil(np.log2(max(E, 1) / max(leaf_elems, 1)))), 0)
    if max_depth is not None:
        D = min(D, max_depth)
    while D > 0 and (1 << D) > E:
        D -= 1
    leaf_of_elem = _median_split_tree(np.asarray(elem_xy, np.float64), D)

    # ---- vertex -> tree node (LCA of element leaves, via min/max leaf) ----
    ev_ok = elem_verts >= 0
    flat_v = elem_verts[ev_ok]
    flat_leaf = np.broadcast_to(leaf_of_elem[:, None], (E, K))[ev_ok]
    vmin = np.full(n_vert, np.iinfo(np.int64).max)
    vmax = np.full(n_vert, -1, dtype=np.int64)
    np.minimum.at(vmin, flat_v, flat_leaf)
    np.maximum.at(vmax, flat_v, flat_leaf)
    if np.any(vmax < 0):
        raise ValueError("multifrontal plan: vertex appears in no element")
    xdiff = vmin ^ vmax
    h = np.zeros(n_vert, dtype=np.int64)
    nz = xdiff > 0
    h[nz] = np.floor(np.log2(xdiff[nz])).astype(np.int64) + 1
    vdepth = D - h
    vnode = vmin >> h            # node index at depth vdepth

    # ---- elimination order: deepest nodes first, in-order within level ----
    order = np.lexsort((np.arange(n_vert), vnode, -vdepth))
    elim = np.empty(n_vert, dtype=np.int64)
    elim[order] = np.arange(n_vert)

    base = (1 << np.arange(D + 2)) - 1          # flat node id offset by depth
    gid = base[vdepth] + vnode
    n_nodes = base[D + 1]
    piv_count = np.bincount(gid, minlength=n_nodes)
    node_order = np.concatenate(
        [base[d] + np.arange(1 << d) for d in range(D, -1, -1)])
    starts = np.zeros(n_nodes, dtype=np.int64)
    starts[node_order] = np.concatenate(
        [[0], np.cumsum(piv_count[node_order])[:-1]])

    def pivots_of(d, i):
        g = base[d] + i
        s = starts[g]
        return order[s:s + piv_count[g]]        # vertex ids, elim-ascending

    # ---- borders bottom-up (vertex ids sorted by elimination index) ----
    borders = [None] * n_nodes
    leaf_sort = np.argsort(leaf_of_elem, kind="stable")
    leaf_cnt = np.bincount(leaf_of_elem, minlength=1 << D)
    leaf_off = np.concatenate([[0], np.cumsum(leaf_cnt)])

    for i in range(1 << D):
        elems = leaf_sort[leaf_off[i]:leaf_off[i + 1]]
        verts = elem_verts[elems]
        verts = np.unique(verts[verts >= 0])
        b = verts[gid[verts] != base[D] + i]
        borders[base[D] + i] = b[np.argsort(elim[b])]
    for d in range(D - 1, -1, -1):
        for i in range(1 << d):
            g = base[d] + i
            b = np.union1d(borders[base[d + 1] + 2 * i],
                           borders[base[d + 1] + 2 * i + 1])
            b = b[gid[b] != g]
            borders[g] = b[np.argsort(elim[b])]
    assert borders[0].size == 0, "root border must be empty"

    # ---- padded per-level arrays ----
    levels = []
    piv_lists = []
    for d in range(D + 1):
        N = 1 << d
        pivs = [pivots_of(d, i) for i in range(N)]
        piv_lists.append(pivs)
        P = max((p.size for p in pivs), default=0)
        B = max((borders[base[d] + i].size for i in range(N)), default=0)
        piv_ids = np.full((N, P), -1, dtype=np.int64)
        for i, p in enumerate(pivs):
            piv_ids[i, :p.size] = p
        levels.append(MFLevel(npiv=P, nbord=B,
                              piv_ids=piv_ids.astype(np.int32),
                              ext=None, bord_in_parent=None, bord_x_slot=None,
                              elem_pt=None, elem_pos=None))

    def front_padded(d, i):
        """PADDED front vertex ids of node (d, i): (F,), -1 at pad slots."""
        lv = levels[d]
        f = np.full(lv.front, -1, dtype=np.int64)
        p = piv_lists[d][i]
        b = borders[base[d] + i]
        f[:p.size] = p
        f[lv.npiv:lv.npiv + b.size] = b
        return f

    def pos_in(sorted_ids, query):
        """Positions of query ids within an elim-sorted id list (-1 = miss)."""
        keys = elim[sorted_ids] if sorted_ids.size else np.empty(0, np.int64)
        q = elim[query]
        pos = np.searchsorted(keys, q)
        pos_c = np.minimum(pos, max(keys.size - 1, 0))
        ok = (keys[pos_c] == q) if keys.size else np.zeros(q.shape, bool)
        return np.where(ok, pos_c, -1)

    # ext maps (parent-front pos -> child border pos), internal levels
    for d in range(D):
        lv = levels[d]
        N = 1 << d
        F = lv.front
        ext = np.full((N, 2, F), -1, dtype=np.int64)
        for i in range(N):
            fv = front_padded(d, i)
            okf = fv >= 0
            for s in (0, 1):
                cb = borders[base[d + 1] + 2 * i + s]
                ext[i, s, okf] = pos_in(cb, fv[okf])
        lv.ext = ext.astype(np.int32)

    # ---- flat x layout: level-major (root first), (N, P) row-major ----
    x_offsets = np.zeros(D + 1, dtype=np.int64)
    pos = 0
    for d in range(D + 1):
        x_offsets[d] = pos
        pos += (1 << d) * levels[d].npiv
    x_slot = np.full(n_vert, -1, dtype=np.int64)
    for d in range(D + 1):
        lv = levels[d]
        ok = lv.piv_ids >= 0
        slots = (x_offsets[d]
                 + np.arange(1 << d)[:, None] * max(lv.npiv, 1)
                 + np.arange(lv.npiv)[None, :])
        x_slot[lv.piv_ids[ok]] = slots[ok]
    assert np.all(x_slot >= 0)

    # bord_in_parent + bord_x_slot, levels 1..D
    for d in range(1, D + 1):
        lv = levels[d]
        N = 1 << d
        B = lv.nbord
        bip = np.full((N, B), -1, dtype=np.int64)
        bxs = np.full((N, B), -1, dtype=np.int64)
        Pp = levels[d - 1].npiv
        for i in range(N):
            b = borders[base[d] + i]
            if b.size == 0:
                continue
            ppiv = piv_lists[d - 1][i // 2]
            pbord = borders[base[d - 1] + i // 2]
            pp = pos_in(ppiv, b)
            pb = pos_in(pbord, b)
            assert np.all((pp >= 0) | (pb >= 0)), \
                "child border vertex missing from parent front"
            bip[i, :b.size] = np.where(pp >= 0, pp, Pp + pb)
            bxs[i, :b.size] = x_slot[b]
        lv.bord_in_parent = bip.astype(np.int32)
        lv.bord_x_slot = bxs.astype(np.int32)

    # leaf element maps
    lvD = levels[D]
    EL = int(leaf_cnt.max()) if leaf_cnt.size else 0
    NL = 1 << D
    elem_pt = np.full((NL, EL), -1, dtype=np.int64)
    elem_pos = np.full((NL, EL, K), -1, dtype=np.int64)
    for i in range(NL):
        elems = leaf_sort[leaf_off[i]:leaf_off[i + 1]]
        elem_pt[i, :elems.size] = elems
        fv = front_padded(D, i)
        okf = fv >= 0
        real = fv[okf]
        padded_pos = np.flatnonzero(okf)
        vv = elem_verts[elems]
        okv = vv >= 0
        safe = np.where(okv, vv, real[0] if real.size else 0)
        p = pos_in(real, safe)
        assert np.all(p[okv] >= 0), "element vertex missing from leaf front"
        elem_pos[i, :elems.size] = np.where(
            okv, padded_pos[np.maximum(p, 0)], -1)
    lvD.elem_pt = elem_pt.astype(np.int32)
    lvD.elem_pos = elem_pos.astype(np.int32)

    return MFPlan(n_vert=n_vert, depth=D, levels=levels,
                  x_offsets=x_offsets, x_size=int(pos), x_slot=x_slot)
