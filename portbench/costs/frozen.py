"""Bytes and operations of the port's kernels, a frozen copy of the cost
functions of the repository's ``chip_smoke.py`` (``cost_h2``, ``cost_h3``,
``cost_h4``, ``cost_h6``, ``cost_h9``, ``_ext_aug``, the closures that cost
H1, H5 and H7, ``_gen_ops`` and ``cost_posterior``), so that the yardstick
stays as it is when the program's tools change.

Every function returns (bytes, operations); ``sz`` is the element size of
the dtype in bytes.  The counting conventions are the originals'."""

from __future__ import annotations

import numpy as np

from . import bessel_terms


def chol_solve_ops(F, rhs=1):
    """Operations of one F x F Cholesky (F^3/3) and rhs pairs of triangular
    solves (2 F^2 each)."""
    return F ** 3 / 3 + 2 * F ** 2 * rhs


def cost_h1(sz, n_all, d, n, F, extra=0):
    """H1 ``matern_solve_e0`` at a closed-form smoothness: locs, nug_point,
    NN, valid, resp in; x out (+ extra bytes); the covariance build takes
    ~12 operations a pair."""
    return (n_all * (d + 1) * sz + n * F * (4 + 2) + n * F * sz + extra,
            n * (chol_solve_ops(F) + 12 * F * (F + 1) / 2))


def cost_h5(sz, n_all, d, n, F):
    """H5 ``matern_solve_e0_bwd`` at a closed-form smoothness: H1's inputs
    plus x and xbar in, dpar (n, 2) f64 and dslot out; ~20 operations a
    pair for the rebuild and the contraction."""
    nbytes, _ = cost_h1(sz, n_all, d, n, F, extra=2 * n * F * sz + 16 * n)
    return nbytes, n * (chol_solve_ops(F) + 20 * F * (F + 1) / 2)


def cost_h1_general(sz, n_all, d, n, F, ops_fwd):
    """H1 at a smoothness without closed form; ``ops_fwd`` the pairs'
    operations (``gen_ops``)."""
    return (n_all * (d + 1) * sz + n * F * (4 + 2) + n * F * sz,
            n * chol_solve_ops(F) + ops_fwd)


def cost_h5_general(sz, n_all, d, n, F, ops_fwd, ops_bwd):
    """H5 at a smoothness without closed form: H1's inputs plus x and xbar
    in, dpar (n, 3) f64 and dslot out; the factor, the solve and ~6
    operations a pair of contraction, plus the pairs' operations."""
    nbytes, _ = cost_h1_general(sz, n_all, d, n, F, ops_fwd)
    return (nbytes + 2 * n * F * sz + 24 * n,
            n * (chol_solve_ops(F) + 6 * F * (F + 1) / 2) + ops_bwd)


def cost_h2(sz, N, F1, epos, n_in, ops):
    """H2 ``leaf_assemble``: epos and the ``n_in`` values of u, rhs_elem,
    dvec and rvec read once, each front's lower triangle (all H2 writes)
    written once; ``ops`` operations."""
    return epos.size * 4 + n_in * sz + N * F1 * (F1 + 1) // 2 * sz, ops


def leaf_inputs(leaf, F1):
    """(n_in, ops) of H2 and H7 at the leaf level ``leaf``: the values of
    u, rhs_elem, dvec and rvec, and one FMA (2 operations) for each entry
    of the lower triangle of each real element's (k+1)-vector outer
    product (k valid slots and the rhs)."""
    N = leaf.elem_pos.shape[0]
    epos = leaf.elem_pos
    k_e = (epos >= 0).sum(-1)[leaf.elem_pt >= 0]
    ops = float(((k_e + 1) * (k_e + 2)).sum())
    n_in = epos.size + leaf.elem_pt.size + 2 * N * F1
    return n_in, ops


def cost_h7(sz, N, F1, epos, elem_pt, ops):
    """H7 ``leaf_assemble_bwd``: dfront's lower triangle, u, epos, rhs_elem
    in; du, d rhs_elem, d dvec, d rvec out."""
    return (N * F1 * (F1 + 1) // 2 * sz + epos.size * 4
            + 2 * (epos.size + elem_pt.size) * sz + 2 * N * F1 * sz), ops


def ext_aug(lv, F1, Bc1):
    """A level's (N, 2, F1) int32 ext map with the augmented entry, as the
    port's multifrontal device arrays build it."""
    ext = np.full((lv.piv_ids.shape[0], 2, F1), -1, np.int32)
    ext[:, :, :F1 - 1] = lv.ext
    ext[:, :, F1 - 1] = Bc1 - 1
    return ext


def cost_h3(sz, N, F1, ext):
    """H3 ``extend_add`` on N fronts with the augmented map ``ext`` (N, 2,
    F1): ext, dvec and rvec read once, of each child the lower triangle of
    the b x b entries its b valid positions gather read once, and each
    front's lower triangle written once; one addition a gathered entry."""
    b = (ext >= 0).sum(-1)
    gathered = float((b * (b + 1) // 2).sum())
    return (ext.size * 4 + 2 * N * F1 * sz + gathered * sz
            + N * F1 * (F1 + 1) // 2 * sz), gathered


def cost_h6(sz, N, F1, Bc1, ext):
    """H6 ``extend_add_bwd``, the transpose of H3 on lower triangles: ext
    read once, of the front cotangent's lower triangle the entries the
    children gather and its diagonal and row F1-1 read once, each child
    block's lower triangle read and written once, d dvec and d rvec
    written; one addition a gathered entry."""
    b = (ext >= 0).sum(-1)
    gathered = float((b * (b + 1) // 2).sum())
    return (ext.size * 4 + gathered * sz + 2 * N * F1 * sz
            + 2 * 2 * N * Bc1 * (Bc1 + 1) // 2 * sz + 2 * N * F1 * sz), \
        gathered


def cost_h4(sz, N, F1, P):
    """H4 ``front_factor`` on N fronts: each front's lower triangle read
    once and written once; the pivot block's Cholesky, the border solve
    and the Schur product's lower triangle."""
    B1 = F1 - P
    return N * F1 * (F1 + 1) * sz, N * (P ** 3 / 3 + B1 * P * P
                                        + B1 * B1 * P)


def cost_h9(sz, N, F1, P, bw=64):
    """H9 ``front_factor_bwd`` on N fronts, the blocked reverse sweep's:
    each front's lower triangle read once and written once; the Schur
    product's reverse 2 B1^2 P, and for each column block [j, k) of ``bw``
    from the last the triangular solve of its F1 - k panel rows (kb^2
    each), Xbar^T C (2 kb^2 (F1 - k)), the diagonal block's reverse (2/3
    kb^3), and the panel products Rbar (2 j kb (F1 - j)) and Bbar (2 j (F1
    - k) kb)."""
    B1 = F1 - P
    ops = 2.0 * B1 * B1 * P
    for j in range(0, P, bw):
        k = min(P, j + bw)
        kb = k - j
        ops += (kb * kb * (F1 - k) + 2.0 * kb * kb * (F1 - k)
                + 2.0 * kb ** 3 / 3 + 2.0 * j * kb * (F1 - j)
                + 2.0 * j * (F1 - k) * kb)
    return N * F1 * (F1 + 1) * sz, N * ops


# general Matern: log K_nu's set-up ~40 operations, Temme's series 14 a
# term (x <= 3), CF2 ~20 a step (x > 3); a pair of the forward adds ~10,
# the backward ~30 (log K at nu, nu + h and |nu - h|)
OPS_LOGK_SETUP, OPS_TEMME_TERM, OPS_CF2_STEP = 40, 14, 20
OPS_PAIR_FWD, OPS_PAIR_BWD = 10, 30


def gen_ops(locs, NN, valid, rho, nu, dt, row_stride=1, step=65536):
    """(forward, backward) operations of the general Matern's pairs of
    the rows ``0, row_stride, 2 row_stride, ...`` (scaled by row_stride),
    at range ``rho`` and smoothness ``nu`` in dtype ``dt`` (torch tensors
    on one device).  Temme's terms grow with x: they are counted on a grid
    of x <= 3 and read at the grid point at or above each pair's x."""
    import torch
    dev = locs.device
    F = NN.shape[1]
    mus = bessel_terms.mus(nu, dt)
    grid = torch.linspace(0.0, 3.0, 3001, dtype=dt, device=dev)[1:]
    terms = [bessel_terms.temme_terms(torch.tensor(mu, dtype=dt,
                                                   device=dev), grid)
             for mu in mus]
    il, jl = torch.tril_indices(F, F, -1, device=dev)
    ops = [0.0] * 3
    pairs = 0
    NN, valid = NN[::row_stride], valid[::row_stride]
    for s0 in range(0, NN.shape[0], step):
        nn, v = NN[s0:s0 + step].long().clamp(min=0), valid[s0:s0 + step]
        pts = locs[nn]
        dist = (pts[:, il] - pts[:, jl]).norm(dim=-1)
        x = (dist[v[:, il] & v[:, jl] & (dist > 0)] / rho).to(dt)
        pairs += x.numel()
        at = torch.bucketize(x[x <= 3.0], grid).clamp(max=len(grid) - 1)
        big = x[x > 3.0]
        for e, mu in enumerate(mus):
            ops[e] += x.numel() * OPS_LOGK_SETUP + OPS_TEMME_TERM * float(
                terms[e][at].sum()) + OPS_CF2_STEP * float(
                    bessel_terms.cf2_steps(torch.tensor(
                        mu, dtype=dt, device=dev), big).sum())
    scale = float(row_stride)
    return (scale * (ops[0] + pairs * OPS_PAIR_FWD),
            scale * (sum(ops) + pairs * OPS_PAIR_BWD))


def cost_posterior(mf, sz):
    """{"backsub" | "selinv": (bytes, operations)} on a kept factor of the
    multifrontal plan ``mf``: each level's L_pp lower triangle and L_bp
    read once and x (the diagonal) written once; the operations of the
    back-substitution and of the selected inverse (at the leaf the
    diagonals alone)."""
    out = {"backsub": [mf.n_vert * sz, 0.0],
           "selinv": [mf.n_vert * sz, 0.0]}
    for d, lv in enumerate(mf.levels):
        N, P, B = lv.piv_ids.shape[0], lv.npiv, lv.nbord
        read = N * (P * (P + 1) // 2 + B * P) * sz
        leaf = d == mf.depth and B > 0 and d > 0
        tail = (P * P + 2 * B * P) if leaf else (P ** 3 / 3 + B * P * P)
        out["backsub"][0] += read
        out["backsub"][1] += N * (P * P + 2 * B * P)
        out["selinv"][0] += read
        out["selinv"][1] += N * (P ** 3 / 3 + B * P * P + 2 * B * B * P
                                 + tail)
    return {k: tuple(v) for k, v in out.items()}
