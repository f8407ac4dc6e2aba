"""Multifrontal level kernels on augmented fronts: H2, H3 and H4.

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
  halves of the leaf and level kernels.

The CUDA kernels are in ``csrc/frontal.cu`` (their source note says what
bounds each one and how the design answers it).  Each ``*_plain`` function
is the plain PyTorch version; CPU tensors take it, CUDA tensors the kernel.
"""

from __future__ import annotations

import torch

from ..csrc import cuda

__all__ = ["leaf_assemble", "leaf_assemble_plain", "extend_add",
           "extend_add_plain", "front_factor", "front_factor_plain"]

_MAX_GRID_Y = 65535


def _same_device(name, ref, *tensors):
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and {ref.device}")
        if t.is_floating_point() and t.dtype != ref.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {ref.dtype}")


def _dispatch(name, ref):
    if ref.device.type == "cpu":
        return False
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
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


def _leaf_launch(u, epos, rhs_elem, dvec, rvec):
    N, EL, K = u.shape
    F1 = dvec.shape[1]
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
    if not _dispatch("leaf_assemble", u):
        return leaf_assemble_plain(u, epos, rhs_elem, dvec, rvec)
    tensors = [t.contiguous() for t in (u, epos, rhs_elem, dvec, rvec)]
    return cuda.KernelCall.apply("leaf_assemble", _leaf_launch, -1, *tensors)


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


def _eadd_launch(upd, ext, dvec, rvec):
    N = upd.shape[0]
    F1 = ext.shape[-1]
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
    if not _dispatch("extend_add", upd):
        return extend_add_plain(upd, ext, dvec, rvec)
    if upd.stride(-1) != 1:
        upd = upd.contiguous()
    if N > _MAX_GRID_Y:
        raise ValueError(f"extend_add: {N} fronts exceed the grid bound")
    ext, dvec, rvec = (t.contiguous() for t in (ext, dvec, rvec))
    return cuda.KernelCall.apply("extend_add", _eadd_launch, -1, upd, ext,
                                 dvec, rvec)


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
    if not _dispatch("front_factor", front):
        return front_factor_plain(front, P)
    if not front.is_contiguous():
        raise ValueError("front_factor: fronts must be contiguous")
    if N > _MAX_GRID_Y:
        raise ValueError(f"front_factor: {N} fronts exceed the grid bound")
    if P == 0:
        return front
    return cuda.KernelCall.apply("front_factor", _factor_launch, 0, front, P)


front_factor.launches = 0
