"""Multifrontal level kernels on augmented fronts: H2, H3 and H4, and
their backward: H9 (the pullback of H4), H6 and H7.

Every front is (F1, F1) with F1 = P + B + 1: P pivots, B border vertices and
one augmented row/column F1-1 that carries the right-hand side, so the
factor's border solve yields y = L_pp^{-1} b in row F1-1 and the Schur
block carries the RHS update to the parent.

* H2 ``leaf_assemble`` replaces the assembly half of the TPU kernel
  ``gpvecchia_tpu/linalg/pallas_level.py`` ``_leaf_kernel`` (``pallas_call``
  at :594, entry ``fused_leaf``).
* H3 ``extend_add`` replaces the assembly halves of ``_level_kernel``
  (:344, ``fused_level``) and ``_afront_kernel`` (:756,
  ``assemble_fronts``), and the forward of ``linalg/pallas_eadd.py``
  ``_fwd_kernel`` (:98, ``eadd_fronts``).
* H4 ``front_factor`` replaces ``linalg/pallas_frontal.py``
  ``_factor_kernel`` (:180, ``factor_fronts``) and the factor and Schur
  halves of the leaf and level kernels: a blocked right-looking factor
  whose last launch forms each front's Schur block once.
* H9 ``front_factor_bwd`` is the pullback of H4, in place on the factored
  front: the custom VJPs of K7 (``pallas_frontal.py:241-270``) and of the
  factor halves of K4/K5 (``pallas_level.py:422-484``, ``:645-687``), which
  the JAX package computes in XLA (``_factor_pullback``, ``_chol_vjp``).
  Its plain version runs ``front_factor_vjp``, that formula ported formula
  for formula (triangular solves and batched products).
* H6 ``extend_add_bwd`` replaces K8b, ``linalg/pallas_eadd.py``
  ``_bwd_kernel`` (:117, ``_eadd_bwd_impl``), and the ``dch`` halves of the
  level and assembly VJPs (``pallas_level.py:436-486, 831-883``).
* H7 ``leaf_assemble_bwd`` replaces the ``du`` half of the leaf VJP
  (``pallas_level.py:655-685``).

Symmetry convention of the backward: a front's cotangent is the symmetric
matrix the JAX package's ``_factor_pullback`` returns, 1/2 (X + X^T).  H9
leaves it in the lower triangle of the front (the upper triangle is
unspecified, as after H4), and H6 and H7 read it through that lower
triangle; ``front_factor_vjp`` returns it full.  A child's Schur-block
cotangent is its gather, symmetric too, of which H6 writes the lower
triangle.

The CUDA kernels are in ``csrc/frontal.cu`` (their source note says what
bounds each one and how the design answers it).  Each ``*_plain`` function
is the plain PyTorch version; CPU tensors take it, CUDA tensors the kernel.
The forward kernels are not differentiable on their own (``mf_factor``
differentiates the whole factor): on CUDA their wrappers raise for inputs
that require grad.
"""

from __future__ import annotations

import ctypes

import torch

from ..csrc import cuda

__all__ = ["leaf_assemble", "leaf_assemble_plain", "extend_add",
           "extend_add_plain", "front_factor", "front_factor_plain",
           "front_factor_vjp", "front_factor_bwd", "front_factor_bwd_plain",
           "extend_add_bwd", "extend_add_bwd_plain",
           "leaf_assemble_bwd", "leaf_assemble_bwd_plain",
           "H2_EDGE_SHAPES", "H3_EDGE_SHAPES", "H4_EDGE_SHAPES",
           "H9_EDGE_SHAPES",
           "h2_edge_inputs", "h3_edge_inputs"]

_MAX_GRID_Y = 65535
_MAX_INT32 = 2 ** 31 - 1
_LEAF_MAX_SLOTS = 2048    # H2 stages a chunk in 8 slots a thread (csrc)

# (N, F1, P) shapes at the edges of H4's blocked schedule (inner panels of
# 32 pivots, outer panels of 128, update tiles of 64 and 128), which the
# card check runs through the kernel and the CPU tests through its plain
# version: P below, at and one past an inner and an outer panel (and at a
# width of 256, twice the outer panel), P = F1 - 1 (no border but the RHS
# row, the root's shape), a Schur block of 2 rows, fronts one past a tile
# (129, 257), one front, several outer panels with and without a border,
# and a Schur block that takes the large tiles with a ragged edge.
H4_EDGE_SHAPES = (
    (2, 40, 7), (2, 33, 32), (2, 70, 32), (2, 70, 33), (2, 40, 39),
    (2, 130, 64), (2, 66, 64), (2, 200, 127), (2, 200, 128), (2, 200, 129),
    (2, 300, 255), (2, 300, 256), (2, 300, 257), (2, 129, 50),
    (2, 257, 100), (1, 150, 60), (1, 600, 599), (3, 700, 300),
    (2, 900, 130))

# H9's column block and outer panel (``H9_BW``, ``H9_OW`` in
# csrc/frontal.cu)
H9_BW = 64
H9_OW = 128

# (N, F1, P) shapes at the edges of H9's schedule (column blocks of 64,
# outer panels of 128, product tiles of 64 and 128, split depths past 256):
# H4's, and P = 0 and 1, P = F1 - 1 one past a block, one front whose deep
# products split, the leaf's P = 105 over two blocks, P at and one past
# three panels, and a last panel of one block.
H9_EDGE_SHAPES = H4_EDGE_SHAPES + (
    (2, 30, 0), (2, 20, 1), (2, 100, 63), (1, 66, 65), (1, 1500, 200),
    (2, 700, 64), (3, 330, 105), (1, 400, 384), (1, 450, 385),
    (2, 260, 192))

# (N, F1, EL, K) shapes at the edges of H2's banded accumulation (rows cut
# into bands of about 64 KB of the lower triangle, elements in chunks of at
# most 32, a group of 16 lanes keeping 64 slots in registers): F1 = 1 and 2
# (the RHS row alone, one pivot), one band with EL = 1, K + 1 slots one past
# 32 and past 64, fronts one past a 64-tile, the leaf's shape at n=1e6,
# m=40 (4 bands in float32, 7 in float64, 3 chunks), and a front of 15
# (float32) and 30 (float64) bands.  ``h2_edge_inputs`` mixes in elements
# of 0 and of K valid slots, pads among the slots, and all-pad elements at
# the end.
H2_EDGE_SHAPES = (
    (2, 1, 3, 4), (2, 2, 3, 4), (3, 40, 1, 5), (2, 40, 20, 31),
    (2, 65, 30, 32), (2, 129, 40, 64), (2, 330, 96, 41), (1, 700, 60, 41))

# (N, F1, Bc1, split) shapes at the edges of H3's 64 x 64 tiles: F1 = 1 and
# 2, one front below, at and one past a tile, several tiles, a child block
# of the RHS row alone (Bc1 = 1), and with ``split`` child 0 on the first
# half of the front's positions and child 1 on the second, so that each is
# absent from whole tiles.
H3_EDGE_SHAPES = (
    (2, 1, 1, False), (2, 2, 2, False), (2, 2, 1, False), (3, 63, 40, False),
    (3, 64, 64, False), (3, 65, 50, False), (2, 129, 64, True),
    (2, 200, 150, False), (2, 257, 128, True), (1, 600, 300, True))


def h2_edge_inputs(N, F1, EL, K, seed):
    """float64 CPU inputs (u, epos, rhs_elem, dvec, rvec) of
    ``leaf_assemble`` at an edge shape: element e has K, 0 or a random
    number of valid slots (e % 3), at random slots and in no order of
    position; the last EL // 5 elements are all pads (RHS weight 0)."""
    g = torch.Generator().manual_seed(seed)
    u = torch.zeros(N, EL, K, dtype=torch.float64)
    epos = torch.full((N, EL, K), -1, dtype=torch.int32)
    re = torch.randn(N, EL, generator=g, dtype=torch.float64)
    real = EL - EL // 5
    re[:, real:] = 0.0
    for n in range(N):
        for e in range(real):
            k = (K, 0, int(torch.randint(1, K + 1, (1,), generator=g)))[e % 3]
            k = min(k, F1 - 1)
            slots = torch.randperm(K, generator=g)[:k]
            pos = torch.randperm(F1 - 1, generator=g)[:k]
            epos[n, e, slots] = pos.int()
            u[n, e, slots] = torch.randn(k, generator=g, dtype=torch.float64)
    dv = 1.0 + torch.rand(N, F1, generator=g, dtype=torch.float64) + 0.5 * K
    rv = torch.randn(N, F1, generator=g, dtype=torch.float64)
    dv[:, F1 - 1] = 0.0
    rv[:, F1 - 1] = 0.0
    return u, epos, re, dv, rv


def h3_edge_inputs(N, F1, Bc1, split, seed):
    """float64 CPU inputs (upd, ext, dvec, rvec) of ``extend_add`` at an
    edge shape: symmetric children's blocks and a monotone ext map with the
    augmented entry F1-1 -> Bc1-1; child s takes up to Bc1-1 random
    positions of the front (with ``split``, of its half only)."""
    g = torch.Generator().manual_seed(seed)
    upd = torch.randn(N, 2, Bc1, Bc1, generator=g, dtype=torch.float64)
    upd = upd + upd.mT
    ext = torch.full((N, 2, F1), -1, dtype=torch.int32)
    half = (F1 - 1) // 2
    for n in range(N):
        for s in (0, 1):
            lo, hi = ((0, half), (half, F1 - 1))[s] if split else (0, F1 - 1)
            k = min(Bc1 - 1, hi - lo)
            pos = lo + torch.randperm(hi - lo, generator=g)[:k].sort().values
            ext[n, s, pos] = torch.arange(k, dtype=torch.int32)
            ext[n, s, F1 - 1] = Bc1 - 1
    dv = 1.0 + torch.rand(N, F1, generator=g, dtype=torch.float64)
    rv = torch.randn(N, F1, generator=g, dtype=torch.float64)
    rv[:, F1 - 1] = 0.0
    return upd, ext, dv, rv


def _same_device(name, ref, *tensors):
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and {ref.device}")
        if t.is_floating_point() and t.dtype != ref.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {ref.dtype}")


def _dispatch(name, ref, *inputs):
    if ref.device.type == "cpu":
        return False
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(f"{name}: the CUDA kernel is not differentiable "
                           "on its own; differentiate mf_factor")
    return True


# ---------------------------------------------------------------- H2 ----

def leaf_assemble_plain(u, epos, rhs_elem, dvec, rvec):
    """front = sum_e a_e a_e^T + diag(dvec) + rvec in row/column F1-1, with
    a_e the element's values at ``epos`` and its RHS weight at F1-1."""
    N, EL, K = u.shape
    F1 = dvec.shape[1]
    ua = torch.zeros(N, EL, F1 + 1, dtype=u.dtype, device=u.device)
    idx = torch.where(epos >= 0, epos, F1).long()     # pads -> trash column
    ua.scatter_add_(2, idx, u)
    ua = ua[..., :F1]
    ua[..., F1 - 1] = rhs_elem
    front = torch.einsum("nef,neg->nfg", ua, ua)
    front = front + torch.diag_embed(dvec)
    front[:, F1 - 1, :] += rvec
    front[:, :, F1 - 1] += rvec
    return front


def _leaf_launch(u, epos, rhs_elem, dvec, rvec, front=None):
    """Launch H2 on contiguous CUDA inputs into ``front`` (a new
    (N, F1, F1) tensor if None; its upper triangles are left as they are)."""
    N, EL, K = u.shape
    F1 = dvec.shape[1]
    if front is None:
        front = torch.empty(N, F1, F1, dtype=u.dtype, device=u.device)
    rc = cuda.entry("gpv_leaf_assemble", u.dtype)(
        u.data_ptr(), epos.data_ptr(), rhs_elem.data_ptr(), dvec.data_ptr(),
        rvec.data_ptr(), N, EL, K, F1, front.data_ptr(),
        cuda.stream(u.device))
    cuda.check(rc, "leaf_assemble")
    leaf_assemble.launches += 1
    return front


def leaf_assemble(u, epos, rhs_elem, dvec, rvec):
    """Augmented leaf fronts (N, F1, F1); the kernel writes the lower
    triangle only (the plain version fills both).

    u: (N, EL, K) element values (0 where absent); epos: (N, EL, K) int32
    front positions (-1 = absent; distinct within an element, < F1-1);
    rhs_elem: (N, EL) per-element RHS weights; dvec, rvec: (N, F1) diagonal
    adds (1.0 at padded pivots) and rhs_vert (0 at F1-1).
    """
    N, EL, K = u.shape
    F1 = dvec.shape[1]
    _same_device("leaf_assemble", u, epos, rhs_elem, dvec, rvec)
    if epos.dtype != torch.int32 or epos.shape != u.shape \
            or rhs_elem.shape != (N, EL) or dvec.shape != (N, F1) \
            or rvec.shape != (N, F1):
        raise ValueError("leaf_assemble: shape/dtype mismatch")
    if not _dispatch("leaf_assemble", u, u, rhs_elem, dvec, rvec):
        return leaf_assemble_plain(u, epos, rhs_elem, dvec, rvec)
    if F1 * F1 > _MAX_INT32 or EL * (K + 1) > _MAX_INT32:
        raise ValueError("leaf_assemble: a front or a front's elements "
                         "exceed 32-bit indexing")
    if K + 1 > _LEAF_MAX_SLOTS:
        raise ValueError(f"leaf_assemble: {K + 1} slots an element exceed "
                         f"the kernel's {_LEAF_MAX_SLOTS}")
    return _leaf_launch(*(t.contiguous()
                          for t in (u, epos, rhs_elem, dvec, rvec)))


leaf_assemble.launches = 0


# ---------------------------------------------------------------- H3 ----

def extend_add_plain(upd, ext, dvec, rvec):
    """front[n, i, j] = sum_s upd[n, s, ext[n,s,i], ext[n,s,j]] + D + RHS."""
    N = upd.shape[0]
    F1 = ext.shape[-1]
    ar = torch.arange(N, device=upd.device)[:, None, None]
    front = torch.zeros(N, F1, F1, dtype=upd.dtype, device=upd.device)
    for s in (0, 1):
        g = ext[:, s].long()
        ok = g >= 0
        gc = g.clamp(min=0)
        sub = upd[:, s][ar, gc[:, :, None], gc[:, None, :]]
        front = front + torch.where(ok[:, :, None] & ok[:, None, :], sub, 0.0)
    front = front + torch.diag_embed(dvec)
    front[:, F1 - 1, :] += rvec
    front[:, :, F1 - 1] += rvec
    return front


def _eadd_launch(upd, ext, dvec, rvec, front=None):
    """Launch H3 as ``_leaf_launch`` launches H2."""
    N = upd.shape[0]
    F1 = ext.shape[-1]
    if front is None:
        front = torch.empty(N, F1, F1, dtype=upd.dtype, device=upd.device)
    sn, sc, sr, _ = upd.stride()
    rc = cuda.entry("gpv_extend_add", upd.dtype)(
        upd.data_ptr(), sn, sc, sr, ext.data_ptr(), dvec.data_ptr(),
        rvec.data_ptr(), N, F1, front.data_ptr(), cuda.stream(upd.device))
    cuda.check(rc, "extend_add")
    extend_add.launches += 1
    return front


def extend_add(upd, ext, dvec, rvec):
    """Augmented parent fronts (N, F1, F1) from the children's updates; the
    kernel writes the lower triangle only (the plain version fills both).

    upd: (N, 2, Bc1, Bc1) children's augmented Schur blocks, symmetric,
    of which the kernel reads the lower triangles (any strides with a unit
    last stride, so a view into the child fronts works); ext:
    (N, 2, F1) int32 parent position -> child row (-1 = absent; F1-1 maps
    to Bc1-1); dvec, rvec: (N, F1) as in ``leaf_assemble``.
    """
    N, two, Bc1, _ = upd.shape
    F1 = ext.shape[-1]
    _same_device("extend_add", upd, ext, dvec, rvec)
    if two != 2 or ext.dtype != torch.int32 or ext.shape != (N, 2, F1) \
            or dvec.shape != (N, F1) or rvec.shape != (N, F1):
        raise ValueError("extend_add: shape/dtype mismatch")
    if not _dispatch("extend_add", upd, upd, dvec, rvec):
        return extend_add_plain(upd, ext, dvec, rvec)
    if upd.stride(-1) != 1:
        upd = upd.contiguous()
    if N > _MAX_GRID_Y:
        raise ValueError(f"extend_add: {N} fronts exceed the grid bound")
    if F1 * F1 > _MAX_INT32 or (Bc1 - 1) * upd.stride(2) + Bc1 > _MAX_INT32:
        raise ValueError("extend_add: a front or a child block exceeds "
                         "32-bit indexing")
    ext, dvec, rvec = (t.contiguous() for t in (ext, dvec, rvec))
    return _eadd_launch(upd, ext, dvec, rvec)


extend_add.launches = 0


# ---------------------------------------------------------------- H4 ----

def front_factor_plain(front, P):
    """In place: L_pp in [:P, :P] (lower), L_bp_aug in [P:, :P], upd_aug
    in [P:, P:] (both triangles).  Non-SPD fronts -> NaN."""
    if P == 0:
        return front
    L, info = torch.linalg.cholesky_ex(front[:, :P, :P])
    L = torch.where((info != 0)[:, None, None], torch.nan, L)
    Lbp = torch.linalg.solve_triangular(L.mT, front[:, P:, :P], upper=True,
                                        left=False)
    upd = front[:, P:, P:] - Lbp @ Lbp.mT
    front[:, :P, :P] = L
    front[:, P:, :P] = Lbp
    front[:, P:, P:] = upd
    return front


def _factor_launch(front, P):
    N, F1, _ = front.shape
    rc = cuda.entry("gpv_front_factor", front.dtype)(
        front.data_ptr(), N, F1, P, cuda.stream(front.device))
    cuda.check(rc, "front_factor")
    front_factor.launches += 1
    return front


def front_factor(front, P):
    """Partial Cholesky of augmented fronts (N, F1, F1) over the first P
    columns, in place; returns ``front``.  Reads only the lower triangle.
    Afterwards the lower [:P, :P] holds L_pp, [P:, :P] holds L_bp_aug =
    A_bp L_pp^{-T} (row F1-1 is y) and the lower triangle of [P:, P:] holds
    upd_aug = A_bb - L_bp_aug L_bp_aug^T.  The upper triangle is
    unspecified (the plain version fills upd_aug's both triangles)."""
    N, F1, F1b = front.shape
    if F1 != F1b or not 0 <= P < F1:
        raise ValueError("front_factor: fronts must be (N, F1, F1), P < F1")
    if not _dispatch("front_factor", front, front):
        return front_factor_plain(front, P)
    if not front.is_contiguous():
        raise ValueError("front_factor: fronts must be contiguous")
    if N > _MAX_GRID_Y:
        raise ValueError(f"front_factor: {N} fronts exceed the grid bound")
    if P == 0:
        return front
    return _factor_launch(front, P)


front_factor.launches = 0


# ------------------------------------------------------- H9 ----

def _chol_vjp(L, Lbar):
    """dA for L = chol(A) given Lbar, from the saved factor alone
    (``pallas_level.py`` ``_chol_vjp``)."""
    M = L.mT @ Lbar
    Phi = torch.tril(M) - 0.5 * torch.diag_embed(torch.diagonal(M, 0, 1, 2))
    S = Phi + Phi.mT
    X = torch.linalg.solve_triangular(L.mT, S, upper=True)          # L^-T S
    dA = torch.linalg.solve_triangular(L, X, upper=False, left=False)
    return 0.25 * (dA + dA.mT)


def front_factor_vjp(front, P, dL_pp, dL_bp, dupd=None):
    """Cotangent (N, F1, F1), full and symmetric, of the fronts that
    ``front_factor`` factored into ``front``, given the cotangents of its
    outputs: dL_pp (N, P, P) of L_pp, dL_bp (N, B1, P) of L_bp_aug and
    dupd (N, B1, B1) of upd_aug (None: zero).

    Reads L_pp through ``tril`` (the kernel leaves the upper triangle of
    [:P, :P] uninitialized) and L_bp_aug from [P:, :P]; never reads [P:, P:].
    The JAX package's ``_factor_pullback`` formula for formula; H9's plain
    version (``launches`` counts its calls: none on the card's path).
    """
    _vjp_count.launches += 1
    N, F1, _ = front.shape
    L = torch.tril(front[:, :P, :P])
    Lbp = front[:, P:, :P]
    dfront = front.new_zeros(N, F1, F1)
    if dupd is not None:
        dupd2 = dupd + dupd.mT                       # 2 sym(dupd)
        dL_bp = dL_bp - dupd2 @ Lbp
        dfront[:, P:, P:] = 0.5 * dupd2
        del dupd2
    dA_bp = torch.linalg.solve_triangular(L, dL_bp, upper=False, left=False)
    corr = torch.linalg.solve_triangular(L.mT, dL_bp.mT @ Lbp, upper=True)
    dfront[:, :P, :P] = _chol_vjp(L, torch.tril(dL_pp) - torch.tril(corr))
    dfront[:, P:, :P] = 0.5 * dA_bp
    dfront[:, :P, P:] = 0.5 * dA_bp.mT
    return dfront


front_factor_vjp.launches = 0
_vjp_count = front_factor_vjp   # counts in the function, even if rebound


def _sym_lower(x):
    """The symmetric matrices whose lower triangles are x's."""
    return torch.tril(x) + torch.tril(x, -1).mT


# bytes of one (chunk, F1, F1) temporary of the plain pullback: it holds
# about eight at once, so ~4 GB a chunk
_BWD_CHUNK_BYTES = 1 << 29


def front_factor_bwd_plain(front, P, g_logdet, g_quad):
    """``front_factor_bwd`` by ``front_factor_vjp``, in node chunks: seeds
    dL_pp = diag(2 g_logdet / L_ii) and dL_bp[B1-1] = 2 g_quad y, the Schur
    cotangent from the lower triangle of [P:, P:]; writes the full
    symmetric cotangent into ``front``."""
    N, F1, _ = front.shape
    if P == 0:
        return front
    B1 = F1 - P
    step = max(1, _BWD_CHUNK_BYTES // (F1 * F1 * front.element_size()))
    for n0 in range(0, N, step):
        fr = front[n0:n0 + step]
        dL_pp = torch.diag_embed(
            2.0 * g_logdet / torch.diagonal(fr[:, :P, :P], 0, 1, 2))
        dL_bp = fr.new_zeros(fr.shape[0], B1, P)
        dL_bp[:, B1 - 1] = 2.0 * g_quad * fr[:, F1 - 1, :P]
        fr.copy_(front_factor_vjp(fr, P, dL_pp, dL_bp,
                                  _sym_lower(fr[:, P:, P:])))
    return front


# elements of H9's buffer of partial sums (its split products)
_H9_WORK = 1 << 22


def _factor_bwd_launch(front, P, g_logdet, g_quad):
    N, F1, _ = front.shape
    dt = front.dtype
    gl = g_logdet.to(dt).reshape(1).contiguous()
    gq = g_quad.to(dt).reshape(1).contiguous()
    # the cotangent of L's diagonal (L keeps its place until a column block
    # is done), a block's Cbar^T C and its diagonal factor's inverse, and the
    # split products' partial sums
    gdiag = front.new_empty(N, P)
    tbuf = front.new_empty(N, H9_BW, H9_BW)
    dbuf = front.new_empty(N, H9_BW, H9_BW)
    work = front.new_empty(_H9_WORK)
    launches = ctypes.c_int(0)
    rc = cuda.entry("gpv_front_factor_bwd", dt)(
        front.data_ptr(), N, F1, P, gl.data_ptr(), gq.data_ptr(),
        gdiag.data_ptr(), tbuf.data_ptr(), dbuf.data_ptr(), work.data_ptr(),
        work.numel(), ctypes.addressof(launches), cuda.stream(front.device))
    cuda.check(rc, "front_factor_bwd")
    front_factor_bwd.launches += 1
    front_factor_bwd.cuda_launches = launches.value
    return front


def front_factor_bwd(front, P, g_logdet, g_quad):
    """H9: the pullback of ``front_factor`` on fronts (N, F1, F1) it
    factored, in place; returns ``front``.

    In: L_pp and L_bp_aug in the lower triangle of [:, :P] as H4 left them,
    and in the lower triangle of [P:, P:] the symmetric cotangent of the
    Schur block upd_aug; g_logdet and g_quad (0-dim tensors), the
    cotangents of logdet = 2 sum log diag L_pp and quad = |y|^2 (y = row
    F1-1 of L_bp_aug).  Out: the lower triangle holds the fronts'
    cotangent, the symmetric 1/2 (X + X^T) of ``front_factor_vjp``.  Reads
    lower triangles only; the upper triangle is unspecified afterwards
    (the kernel keeps its accumulating cotangent there, the plain version
    fills both).  The factor is gone afterwards."""
    N, F1, F1b = front.shape
    if F1 != F1b or not 0 <= P < F1:
        raise ValueError("front_factor_bwd: fronts must be (N, F1, F1), "
                         "P < F1")
    g_logdet = torch.as_tensor(g_logdet, dtype=front.dtype,
                               device=front.device)
    g_quad = torch.as_tensor(g_quad, dtype=front.dtype, device=front.device)
    if not _dispatch("front_factor_bwd", front, front):
        return front_factor_bwd_plain(front, P, g_logdet, g_quad)
    if not front.is_contiguous():
        raise ValueError("front_factor_bwd: fronts must be contiguous")
    if N > _MAX_GRID_Y:
        raise ValueError(f"front_factor_bwd: {N} fronts exceed the grid "
                         "bound")
    if P == 0:
        return front
    return _factor_bwd_launch(front, P, g_logdet, g_quad)


front_factor_bwd.launches = 0
front_factor_bwd.cuda_launches = 0   # CUDA launches of its last call


# ---------------------------------------------------------- H6 ----

def _diag_rhs_bwd(dfront):
    """(d dvec, d rvec): dvec[f] enters front[f, f], rvec[f] enters
    front[F1-1, f] and front[f, F1-1] (``_diag_rhs_cotangent``); the
    kernels read 2 dfront[F1-1, f], the same for a symmetric dfront."""
    F1 = dfront.shape[-1]
    return (torch.diagonal(dfront, 0, 1, 2).clone(),
            dfront[:, F1 - 1, :] + dfront[:, :, F1 - 1])


def _inverse_ext(ext, Bc1):
    """(N, 2, Bc1) int32 child position -> parent position (-1 = absent)
    from the (N, 2, F1) parent -> child map (injective per child)."""
    N, _, F1 = ext.shape
    inv = torch.full((N, 2, Bc1 + 1), -1, dtype=torch.int32,
                     device=ext.device)
    pos = torch.arange(F1, dtype=torch.int32, device=ext.device)
    inv.scatter_(2, torch.where(ext >= 0, ext, Bc1).long(),
                 pos.expand(N, 2, F1).contiguous())
    return inv[..., :Bc1].contiguous()


def extend_add_bwd_plain(dfront, ext, Bc1):
    """(dupd (N, 2, Bc1, Bc1), d dvec, d rvec): dupd[n, s] = G_s^T dfront
    G_s for the selection G_s of ``ext[n, s]``, i.e. dupd[s][a][b] =
    dfront[inv_s(a)][inv_s(b)] (0 where a child position is absent)."""
    N = dfront.shape[0]
    inv = _inverse_ext(ext, Bc1).long()
    ok = inv >= 0
    ic = inv.clamp(min=0)
    ar = torch.arange(N, device=dfront.device)[:, None, None, None]
    sub = dfront[ar, ic[:, :, :, None], ic[:, :, None, :]]
    dupd = torch.where(ok[:, :, :, None] & ok[:, :, None, :], sub, 0.0)
    return (dupd,) + _diag_rhs_bwd(dfront)


def _eadd_bwd_launch(dfront, inv, out):
    N, F1, _ = dfront.shape
    Bc1 = inv.shape[-1]
    ddv = torch.empty(N, F1, dtype=dfront.dtype, device=dfront.device)
    drv = torch.empty_like(ddv)
    sn, sc, sr, _ = out.stride()
    rc = cuda.entry("gpv_extend_add_bwd", dfront.dtype)(
        dfront.data_ptr(), N, F1, inv.data_ptr(), Bc1, out.data_ptr(), sn, sc,
        sr, ddv.data_ptr(), drv.data_ptr(), cuda.stream(dfront.device))
    cuda.check(rc, "extend_add_bwd")
    extend_add_bwd.launches += 1
    return ddv, drv


def extend_add_bwd(dfront, ext, out):
    """Backward of ``extend_add``: ``out += G_s^T dfront G_s`` per child,
    in place, and returns (d dvec, d rvec), each (N, F1).

    dfront: (N, F1, F1) symmetric parent cotangents, read through their
    lower triangles (as H9 leaves them); ext: (N, 2, F1) int32 as in
    ``extend_add``; out: (N, 2, Bc1, Bc1) children's Schur-block
    cotangents, any strides with a unit last stride, so a view into the
    child fronts' [P_c:, P_c:] blocks works.  The kernel adds into the
    lower triangles only (ext is monotone, so lower maps to lower); the
    plain version into both.
    """
    N, F1, _ = dfront.shape
    Bc1 = out.shape[-1]
    _same_device("extend_add_bwd", dfront, ext, out)
    if ext.dtype != torch.int32 or ext.shape != (N, 2, F1) \
            or out.shape != (N, 2, Bc1, Bc1) or dfront.shape != (N, F1, F1):
        raise ValueError("extend_add_bwd: shape/dtype mismatch")
    if not _dispatch("extend_add_bwd", dfront, dfront, out):
        dupd, ddv, drv = extend_add_bwd_plain(_sym_lower(dfront), ext, Bc1)
        out += dupd
        return ddv, drv
    if out.stride(-1) != 1:
        raise ValueError("extend_add_bwd: out needs a unit last stride")
    if N > _MAX_GRID_Y:
        raise ValueError(f"extend_add_bwd: {N} fronts exceed the grid bound")
    if F1 * F1 > _MAX_INT32 or (Bc1 - 1) * out.stride(2) + Bc1 > _MAX_INT32:
        raise ValueError("extend_add_bwd: a front or a child block exceeds "
                         "32-bit indexing")
    return _eadd_bwd_launch(dfront.contiguous(), _inverse_ext(ext, Bc1), out)


extend_add_bwd.launches = 0


# ---------------------------------------------------------- H7 ----

def leaf_assemble_bwd_plain(dfront, u, epos, rhs_elem):
    """(du, d rhs_elem, d dvec, d rvec) of ``leaf_assemble`` for a full
    symmetric dfront: with a_e the element's augmented front vector,
    d a_e = 2 dfront a_e, read back at the element's positions."""
    N, EL, K = u.shape
    F1 = dfront.shape[-1]
    ua = torch.zeros(N, EL, F1 + 1, dtype=u.dtype, device=u.device)
    idx = torch.where(epos >= 0, epos, F1).long()
    ua.scatter_add_(2, idx, u)
    ua = ua[..., :F1]
    ua[..., F1 - 1] = rhs_elem
    dua = 2.0 * ua @ dfront
    du = torch.where(epos >= 0, torch.gather(dua, 2, idx.clamp(max=F1 - 1)),
                     0.0)
    return (du, dua[..., F1 - 1]) + _diag_rhs_bwd(dfront)


def _leaf_bwd_launch(dfront, u, epos, rhs_elem):
    N, EL, K = u.shape
    F1 = dfront.shape[-1]
    du = torch.empty_like(u)
    dre = torch.empty_like(rhs_elem)
    ddv = torch.empty(N, F1, dtype=u.dtype, device=u.device)
    drv = torch.empty_like(ddv)
    rc = cuda.entry("gpv_leaf_assemble_bwd", u.dtype)(
        dfront.data_ptr(), u.data_ptr(), epos.data_ptr(), rhs_elem.data_ptr(),
        N, EL, K, F1, du.data_ptr(), dre.data_ptr(), ddv.data_ptr(),
        drv.data_ptr(), cuda.stream(u.device))
    cuda.check(rc, "leaf_assemble_bwd")
    leaf_assemble_bwd.launches += 1
    return du, dre, ddv, drv


def leaf_assemble_bwd(dfront, u, epos, rhs_elem):
    """Backward of ``leaf_assemble`` for a symmetric cotangent dfront
    (N, F1, F1), read through its lower triangle (as H9 leaves it):
    (du (N, EL, K), d rhs_elem (N, EL), d dvec, d rvec), with

        du[e, k]  = 2 (sum_l dfront[p_k, p_l] u[e, l] + dfront[p_k, F1-1] re[e])
        dre[e]    = 2 (sum_k dfront[F1-1, p_k] u[e, k] + dfront[F1-1, F1-1] re[e])

    (p = epos[e]; du = 0 at absent slots).
    """
    N, EL, K = u.shape
    F1 = dfront.shape[-1]
    _same_device("leaf_assemble_bwd", dfront, u, epos, rhs_elem)
    if epos.dtype != torch.int32 or epos.shape != u.shape \
            or rhs_elem.shape != (N, EL) or dfront.shape != (N, F1, F1):
        raise ValueError("leaf_assemble_bwd: shape/dtype mismatch")
    if not _dispatch("leaf_assemble_bwd", dfront, dfront, u, rhs_elem):
        return leaf_assemble_bwd_plain(_sym_lower(dfront), u, epos, rhs_elem)
    if N > _MAX_GRID_Y:
        raise ValueError(f"leaf_assemble_bwd: {N} fronts exceed the grid "
                         "bound")
    return _leaf_bwd_launch(*(t.contiguous()
                              for t in (dfront, u, epos, rhs_elem)))


leaf_assemble_bwd.launches = 0
