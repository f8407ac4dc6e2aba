"""The log-determinant and the quadratic form of a Vecchia likelihood's
latent precision, by a plain multifrontal Cholesky factor in torch.

The latent precision is W = sum_c u_c u_c^T over the columns c of U that
have latent rows: each latent column's entries on the latents it
conditions on (itself first), and each observation's column
-1/sqrt(nugget) on its own latent.  Appending the columns' values of
z1 = U_z^T z as one more coordinate gives the augmented matrix

    A = [[W, z2], [z2^T, |z1|^2]] = sum_c a_c a_c^T,   z2 = U_y z1,

and eliminating every latent from A leaves |z1|^2 - z2^T W^{-1} z2 in the
augmented corner, beside log det W from the pivots.

Elimination order (``build_tree``, host NumPy, parameter-free): columns
are split into a binary tree by median cuts of their points; a latent
belongs to the lowest common ancestor of the leaves of the columns that
touch it, so two latents that share a column sit on one root-to-leaf path,
and a node's latents are eliminated after its children's.  Each node's
front holds its own latents, then its border (the later latents its
columns and its children's borders reach), then the augmented coordinate.

Numbers (``eliminate``, torch, differentiable): level by level from the
leaves, a node's front is M^T M (M: its columns' entries at their front
positions) plus its children's Schur complements, and its pivots are
factored by ``torch.linalg.cholesky``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Level:
    """The padded fronts of one depth: N nodes, P pivots, S border
    positions, C columns a node; index arrays into flat (N, C, F) and
    (N, F, F) tensors, F = P + S + 1."""
    N: int
    P: int
    S: int
    C: int
    m_lat: np.ndarray       # (E,) flat M index of each latent-column entry
    m_lat_src: np.ndarray   # (E,) flat (column * K + slot) source of it
    m_aug: np.ndarray       # (Cl,) flat M index of each latent column's z1
    m_aug_src: np.ndarray   # (Cl,) its column
    m_obs: np.ndarray       # (Co,) flat M index of each observation's entry
    m_obs_aug: np.ndarray   # (Co,) flat M index of its z1
    m_obs_src: np.ndarray   # (Co,) its latent (the ordered point)
    pad_diag: np.ndarray    # flat (N, F, F) index of padded pivots
    up_map: np.ndarray | None   # (N, S + 1) parent front position of each
                                # border position and the augmented one

    @property
    def F(self):
        return self.P + self.S + 1


def _median_leaves(xy, depth):
    """Leaf (0 .. 2**depth - 1, in order) of each column: median cuts
    across the wider extent of each node's points."""
    leaf = np.zeros(xy.shape[0], dtype=np.int64)
    nodes = [np.arange(xy.shape[0])]
    for _ in range(depth):
        nxt = []
        for ids in nodes:
            sub = xy[ids]
            dim = int(np.argmax(sub.max(axis=0) - sub.min(axis=0))) \
                if ids.size else 0
            srt = ids[np.argsort(sub[:, dim], kind="stable")]
            h = srt.size // 2
            nxt += [srt[:h], srt[h:]]
        nodes = nxt
    for j, ids in enumerate(nodes):
        leaf[ids] = j
    return leaf


def _bitlen(x):
    out = np.zeros(x.shape, dtype=np.int64)
    x = x.copy()
    while np.any(x):
        nz = x > 0
        out[nz] += 1
        x >>= 1
    return out


def build_tree(locsord, NN, cond, depth):
    """The levels (root first) of the elimination of W for a spec whose
    every point carries a latent and an observation: latent column i
    touches the latents NN[i, cond[i]]."""
    n, K = NN.shape
    D = depth
    memb = np.where(cond & (NN >= 0), NN, -1)
    leaf = (1 << D) + _median_leaves(locsord, D)        # heap ids
    col = np.repeat(np.arange(n), K)
    v = memb.ravel()
    ok = v >= 0
    col, v = col[ok], v[ok]
    lo = np.full(n, np.iinfo(np.int64).max)
    hi = np.zeros(n, dtype=np.int64)
    np.minimum.at(lo, v, leaf[col])
    np.maximum.at(hi, v, leaf[col])
    h = _bitlen(lo ^ hi)
    owner = lo >> h                                      # lowest common ancestor
    odepth = D - h
    # each latent column goes to its deepest member's node, where all its
    # members are still uneliminated
    mdepth = np.where(memb >= 0, odepth[np.maximum(memb, 0)], -1)
    deep = np.take_along_axis(memb, mdepth.argmax(axis=1)[:, None], 1)[:, 0]
    cnode = owner[deep]

    # borders, from the leaves up: a node's columns' members and its
    # children's borders, less its own latents
    cdepth = odepth[deep]
    border = {}                        # depth -> (node, vertex) pairs, sorted
    lifted = np.empty((0, 2), dtype=np.int64)
    pair_node = cnode[col]
    pair_depth = cdepth[col]
    for d in range(D, -1, -1):
        sel = pair_depth == d
        pn = np.concatenate([pair_node[sel], lifted[:, 0]])
        pv = np.concatenate([v[sel], lifted[:, 1]])
        keep = owner[pv] != pn
        key = np.unique(pn[keep] * n + pv[keep])
        border[d] = np.stack([key // n, key % n], axis=1)
        lifted = border[d].copy()
        lifted[:, 0] >>= 1
    levels = []
    pos_of = {}
    for d in range(D + 1):
        N = 1 << d
        base = N
        own = np.flatnonzero(odepth == d)
        own = own[np.argsort(owner[own], kind="stable")]
        on = owner[own] - base
        npiv = np.bincount(on, minlength=N)
        P = int(npiv.max()) if own.size else 0
        prank = np.arange(own.size) - np.repeat(np.cumsum(npiv) - npiv, npiv)
        bd = border[d]
        bn = bd[:, 0] - base
        nb = np.bincount(bn, minlength=N)
        S = int(nb.max()) if bd.size else 0
        brank = np.arange(bd.shape[0]) - np.repeat(np.cumsum(nb) - nb, nb)
        F = P + S + 1
        # front position of (node, vertex): own latents, then the border
        keys = np.concatenate([owner[own] * n + own, bd[:, 0] * n + bd[:, 1]])
        posv = np.concatenate([prank, P + brank])
        srt = np.argsort(keys, kind="stable")
        pos_of[d] = (keys[srt], posv[srt])

        def pos(nodes, verts, d=d):
            k, p = pos_of[d]
            q = nodes * n + verts
            i = np.searchsorted(k, q)
            if not np.array_equal(k[np.minimum(i, k.size - 1)], q):
                raise AssertionError("a member outside its column's front")
            return p[i]

        # the node's columns: its latent columns, then its observations
        lc = np.flatnonzero(cdepth == d)
        lc = lc[np.argsort(cnode[lc], kind="stable")]
        nl = np.bincount(cnode[lc] - base, minlength=N)
        no = npiv
        C = int((nl + no).max()) if (lc.size or own.size) else 0
        lrank = np.arange(lc.size) - np.repeat(np.cumsum(nl) - nl, nl)
        orank = nl[on] + prank
        lnode = cnode[lc] - base
        slots = memb[lc] >= 0
        li, lj = np.nonzero(slots)
        m_lat = ((lnode[li] * C + lrank[li]) * F
                 + pos(cnode[lc][li], memb[lc][li, lj]))
        m_aug = (lnode * C + lrank) * F + F - 1
        m_obs = (on * C + orank) * F + prank
        m_obs_aug = (on * C + orank) * F + F - 1
        pn, pp = np.nonzero(np.arange(P)[None, :] >= npiv[:, None])
        levels.append(Level(
            N=N, P=P, S=S, C=C,
            m_lat=m_lat, m_lat_src=lc[li] * K + lj,
            m_aug=m_aug, m_aug_src=lc,
            m_obs=m_obs, m_obs_aug=m_obs_aug, m_obs_src=own,
            pad_diag=pn * F * F + pp * (F + 1),
            up_map=None))
        if d > 0:
            # each border position's place in the parent's front
            up = np.zeros((N, S + 1), dtype=np.int64)
            up[bn, brank] = pos(bd[:, 0] >> 1, bd[:, 1], d=d - 1)
            up[:, S] = levels[d - 1].F - 1
            levels[d].up_map = up
    return levels


def eliminate(levels, col, z1, nug, zord, device):
    """(log det W, |z1|^2 - z2^T W^{-1} z2) as 0-dim tensors, from the
    latent columns' entries ``col`` (n, K), their z1 values ``z1`` (n,),
    the nugget and the ordered observations; differentiable in col, z1 and
    nug."""
    dt = col.dtype
    isq = torch.rsqrt(nug)
    flat = col.reshape(-1)
    logdet = torch.zeros((), dtype=dt, device=device)
    schur = None
    for d in range(len(levels) - 1, -1, -1):
        lv = levels[d]
        N, P, S, C, F = lv.N, lv.P, lv.S, lv.C, lv.F
        t = lv.dev
        vals = torch.cat([flat[t["m_lat_src"]], z1[t["m_aug_src"]],
                          (-isq).expand(t["m_obs_src"].shape),
                          zord[t["m_obs_src"]] * isq])
        M = torch.zeros(N * C * F, dtype=dt, device=device).index_put(
            (t["m_idx"],), vals)
        M = M.view(N, C, F)
        front = M.mT @ M
        fl = front.view(-1)
        fl.index_put_((t["pad_diag"],), torch.ones(
            t["pad_diag"].shape, dtype=dt, device=device), accumulate=True)
        if schur is not None:
            child = levels[d + 1]
            rm = child.dev["up_map"]                       # (2N, Sc + 1)
            par = torch.arange(2 * N, device=device) // 2
            step = max(1, int(2e8 // rm.shape[1] ** 2))
            for s0 in range(0, 2 * N, step):
                r = rm[s0:s0 + step]
                idx = (par[s0:s0 + step, None, None] * (F * F)
                       + r[:, :, None] * F + r[:, None, :])
                fl.index_put_((idx.reshape(-1),),
                              schur[s0:s0 + step].reshape(-1),
                              accumulate=True)
        if P == 0:
            schur = front
            continue
        L = torch.linalg.cholesky(front[:, :P, :P])
        logdet = logdet + 2.0 * torch.log(
            torch.diagonal(L, dim1=1, dim2=2)).sum()
        X = torch.linalg.solve_triangular(L, front[:, :P, P:], upper=False)
        schur = front[:, P:, P:] - X.mT @ X
    return logdet, schur.reshape(-1)[0]


def to_device(levels, device):
    """Put each level's index arrays on ``device`` (as ``lv.dev``)."""
    for lv in levels:
        lv.dev = {k: torch.as_tensor(getattr(lv, k), device=device).long()
                  for k in ("m_lat_src", "m_aug_src", "m_obs_src",
                            "pad_diag")}
        lv.dev["m_idx"] = torch.as_tensor(np.concatenate(
            [lv.m_lat, lv.m_aug, lv.m_obs, lv.m_obs_aug]), device=device).long()
        if lv.up_map is not None:
            lv.dev["up_map"] = torch.as_tensor(lv.up_map, device=device)
    return levels
