"""H1 ``matern_solve_e0``: per point, x = C^{-1} e0 for the built-in Matern
covariance C of its conditioning set; H5 ``matern_solve_e0_bwd``, its
backward in (covparms, nuggets); H8 ``solve_e0``, the same solve on a given
packed covariance; and ``solve_e0_bwd``, H8's backward.

H1 replaces the TPU kernel ``gpvecchia_tpu/kernels/pallas_crout.py``
``_fused_kernel`` (``pallas_call`` at :268, entry ``fused_matern_solve``).
H5 replaces K2, ``_solve_e0_bwd_kernel`` (``pallas_call`` at :155,
``_solve_e0_bwd_impl``), fused with the covariance rebuild ``_rebuild_cp``
and the Matern VJP that the fused solver's backward (:302-356) runs around
it.  H8 replaces K3, ``_solve_e0_kernel`` (``pallas_call`` at :140,
``_solve_e0_impl``, entry ``packed_solve_e0``).  ``solve_e0_bwd`` is K2 one
to one.

H1 and H5 take the closed forms (smoothness 0.5, 1.5, 2.5) and, as
``matern_solve_e0[general]`` and ``matern_solve_e0_bwd[general]``, the
Matern at any other smoothness: there each pair's log K_nu is evaluated
in the kernel (``csrc/matern_common.cuh`` ``log_kv``) from constants that
depend on nu alone, computed once a launch on the host
(``general_params``).  This is what the JAX package computes for a general
smoothness with ``build_cov_packed`` + K3 (``u_entries.py:296-320``) and,
in the backward, K2 with ``covariance.py`` ``_matern_bwd``; no packed
covariance is written.  On the shared-memory route the general instances
evaluate each point's pairs as a list sorted by log K's branch (Temme's
series at s <= 3, CF2 above) and by s, taken 32 at a time, so a warp
seldom pays for both branches (``csrc/matern_solve.cu``, the general pair
pass); H5 evaluates each pair once and keeps g, dg/ds and dg/dnu in shared
memory for its contraction.  Their ``stats`` (``STATS_FIELDS``) count the
pass: the branch mix and the warp passes against the column walk's.

H1 and H5 take one of two CUDA routes, by F and dtype alone (``route``):
up to ``REGS_MAX_F`` the register route
(``csrc/matern_regs.cuh``: one warp a point, F padded with identity slots to
a multiple of 8, each lane's rows of the matrix in registers), above it the
shared-memory route (``csrc/matern_solve.cu``: one warp a point, the
matrix in shared memory).  H8 and ``solve_e0_bwd`` take the same two
routes by the same rule, the register route's build step loading the
point's packed row.  None is bound by memory (see the note at the head of
``csrc/matern_solve.cu``).
Each ``*_plain`` function is the plain
PyTorch version (batched ``torch.linalg.cholesky_ex`` and
``cholesky_solve``; log K_nu by ``kernels/bessel.py``); CPU tensors take
it, CUDA tensors the kernel.

``matern_solve_e0`` is a ``torch.autograd.Function`` on both devices: its
backward is H5 on CUDA and H5's plain version on the CPU, and returns the
gradients of ``covparms`` and ``nug_point`` on their own devices and dtypes.
d/dnu is 0 at the closed forms (the smoothness selects one) and the
central difference of log K_nu (``bessel.log_kv_vjp``) elsewhere.
"""

from __future__ import annotations

import functools
import math
import weakref

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..csrc import cuda
from ..linalg.sparse import device_schedule, segment_sum
from ..plan import slot_sum_schedule
from ..utils import trace
from .bessel import _MAX_CLIMB, _SERIES_ITERS, _temme_mu, nu_step
from .covariance import (GENERAL, matern, matern_dgds, matern_general_dg,
                         nu_index, safe_dist)

__all__ = ["matern_solve_e0", "matern_solve_e0_plain", "matern_solve_e0_bwd",
           "matern_solve_e0_bwd_plain", "solve_e0", "solve_e0_plain",
           "packed_solve_e0", "solve_e0_bwd", "solve_e0_bwd_plain",
           "max_neighbors", "general_params"]

_SMEM_PER_BLOCK = 48 * 1024     # static-launch shared-memory bound
_SMEM_OPT_IN = 232448           # a block's dynamic shared memory at most
_MAX_WARPS = 8
_FWD_VECS, _BWD_VECS = 3, 4     # F-vectors per warp beside C and coordinates
_NBIN = 32                      # the general pair list's bins of s
# what the general instances on the shared-memory route add to a launch's
# ``stats`` (int64, on the card), a point at a time: csrc/matern_solve.cu
# ``count_pairs``
STATS_FIELDS = ("points", "temme_pairs", "cf2_pairs", "list_passes",
                "column_passes", "mixed_passes")
# H1, H5, H8 and solve_e0_bwd take the register route (csrc/matern_regs.cuh)
# up to this F, its largest instance in csrc/matern_regs_f32.cu and _f64.cu,
# and the shared-memory route (csrc/matern_solve.cu) above it
REGS_MAX_F = {torch.float32: 64, torch.float64: 32}


def route(F: int, dtype: torch.dtype) -> str:
    """The CUDA route of H1, H5, H8 and ``solve_e0_bwd`` at F and dtype:
    "registers" or "shared".  Chosen by F and dtype alone."""
    return "registers" if F <= REGS_MAX_F[dtype] else "shared"


# the layout of ``csrc/matern_common.cuh`` ``gen_params``: per order of log K
# (nu, nu + h, |nu - h|) KV_WORDS values, then nu, c0, dnu0, 1 / (2 h)
KV_WORDS = 8 + 3 * _SERIES_ITERS


def _kv_words(mus, ks) -> list[float]:
    """What log K_{mu+k} needs of its order alone, in float64, for each
    order: mu, mu^2, then ``bessel._temme_mu``'s pi mu / sin(pi mu),
    gamma_1 and gamma_2 (with its guards), 0.5 Gamma(1 + mu), 0.5 Gamma(1 -
    mu), k, and the 40 terms' 1 / (i^2 - mu^2), 1 / (i - mu), 1 / (i +
    mu)."""
    consts = torch.stack(_temme_mu(torch.tensor(mus, dtype=torch.float64)),
                         1).tolist()
    i = np.arange(1, _SERIES_ITERS + 1, dtype=np.float64)
    words = []
    for mu, k, (fact, gam1, gam2, gampl, gammi) in zip(mus, ks, consts):
        with np.errstate(divide="ignore"):
            tables = np.concatenate([1.0 / (i * i - mu * mu), 1.0 / (i - mu),
                                     1.0 / (i + mu)])
        words += [mu, mu * mu, fact, gam1, gam2, 0.5 / gampl, 0.5 / gammi,
                  float(k)] + tables.tolist()
    return words


def general_params(nu, dtype: torch.dtype) -> np.ndarray:
    """The general Matern's constants for one launch at smoothness ``nu``
    in ``dtype``: float64 (3 KV_WORDS + 4,), read-only, the kernel
    parameter of the general instances of H1 and H5.  The orders nu, nu + h
    and |nu - h| (h = ``bessel.nu_step(dtype)``), their k = clamp(round(.),
    0, 24) and mu = order - k are formed in ``dtype``, as the plain version
    forms them; what follows from them in float64.  Kept for the last
    smoothnesses: a value's backward and repeated calls at one smoothness
    reuse them (they take some tenths of a millisecond of host time)."""
    return _general_params(float(nu), dtype)


@functools.lru_cache(maxsize=64)
def _general_params(nu: float, dtype: torch.dtype) -> np.ndarray:
    npt = np.float32 if dtype == torch.float32 else np.float64
    nu_t = npt(nu)
    h = npt(nu_step(dtype))
    orders = (nu_t, npt(nu_t + h), np.abs(npt(nu_t - h)))
    ks = [float(np.clip(np.round(o), 0, _MAX_CLIMB)) for o in orders]
    words = _kv_words([float(npt(o - npt(k))) for o, k in zip(orders, ks)],
                      ks)
    nu64 = float(nu_t)
    digamma = float(torch.special.digamma(torch.tensor(nu64,
                                                       dtype=torch.float64)))
    words += [nu64, (1.0 - nu64) * math.log(2.0) - math.lgamma(nu64),
              -math.log(2.0) - digamma, 1.0 / (2.0 * float(h))]
    out = np.asarray(words, dtype=np.float64)
    out.setflags(write=False)
    return out


def _up16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _smem_per_warp(F: int, d: int, itemsize: int, vecs: int,
                   general: bool = False) -> int:
    """Shared memory a warp on the shared-memory route: the F x F matrix,
    F x d coordinates and ``vecs`` F-vectors.  The general Matern's
    instances (``general``) add their pair list (a membership bit and a
    16-bit index a pair of the strict lower triangle, the bins' counts) and
    in the backward (``vecs == _BWD_VECS``) the dg/ds and dg/dnu triangles:
    csrc/matern_solve.cu ``gen_warp_bytes``."""
    words = F * F + F * d + vecs * F
    if not general:
        return words * itemsize
    pairs = F * (F - 1) // 2
    if vecs == _BWD_VECS:
        words += 2 * pairs
    return (_up16(words * itemsize) + _up16(4 * ((pairs + 31) // 32 + _NBIN))
            + _up16(2 * pairs))


def _max_f(d: int, dtype: torch.dtype, vecs: int) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    F = 1
    while _smem_per_warp(F + 1, d, itemsize, vecs) <= _SMEM_PER_BLOCK:
        F += 1
    return F


def max_neighbors(d: int, dtype: torch.dtype) -> int:
    """Largest F = m+1 that the forward and the backward take: one warp's
    F x F matrix, F x d coordinates and four F-vectors (H5's) must fit 48 KB
    of shared memory.  For d=2 that is F=75 in float64, F=107 in float32.
    The forward holds three F-vectors but takes the same bound, so a value
    is only computed where its gradient can be.  The general Matern takes
    the same bound: on the shared-memory route its instances add a pair
    list and, in the backward, the dg/ds and dg/dnu triangles (g itself in
    the matrix's free upper triangle), and take dynamic shared memory
    above 48 KB a block (99 KB a warp for H5 at F=75 in float64); the
    register route's fourth triangle fits its 227 KB at every F it takes.
    Above the bound ``u_entries`` gives the general Matern to the packed
    path."""
    return _max_f(d, dtype, _BWD_VECS)


def _warps(name, F, d, dtype, vecs, bound, general=False):
    """Warps per block for F x F matrices and ``vecs`` F-vectors a warp
    (with the general Matern's pair list and triangles: ``general``): as
    many as fit 48 KB, else one warp with the larger dynamic size, which
    the launch allows; raises above ``bound``."""
    if F > bound:
        raise ValueError(
            f"{name}: F={F} exceeds the shared-memory bound "
            f"F <= {bound} for d={d}, {dtype}")
    per_warp = _smem_per_warp(F, d, torch.empty((), dtype=dtype).element_size(),
                              vecs, general)
    if per_warp > _SMEM_OPT_IN:
        raise ValueError(f"{name}: {per_warp} bytes of shared memory a warp "
                         f"at F={F}, d={d}, {dtype}")
    return max(1, min(_MAX_WARPS, _SMEM_PER_BLOCK // per_warp))


def _chunk(F):
    return max(1, (1 << 23) // (F * F))         # ~8M matrix entries a chunk


def _cov_chunk(locs, nn, v, r, nug_point, covparms):
    """(C, dist) of one chunk of points: the conditioning covariances with
    the response nuggets on the diagonal and invalid slots identity-extended,
    and the pair distances."""
    F = nn.shape[1]
    pts = locs[nn]                                          # (c, F, d)
    diff = pts[:, :, None, :] - pts[:, None, :, :]
    dist = safe_dist((diff * diff).sum(-1))
    C = matern(dist, covparms)
    C = C + torch.diag_embed(torch.where(r, nug_point[nn], 0.0))
    eye = torch.eye(F, dtype=locs.dtype, device=locs.device)
    return torch.where(v[:, :, None] & v[:, None, :], C, eye), dist


def _solve(C, rhs):
    """C^{-1} rhs per point; NaN rows where C is not SPD."""
    L, info = torch.linalg.cholesky_ex(C)
    x = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    return torch.where((info != 0)[:, None], torch.nan, x)


def matern_solve_e0_plain(locs, NN, valid, resp, nug_point, covparms):
    """Plain PyTorch version: (n, F) solutions, NaN rows where the
    conditioning covariance is not SPD.  Differentiable by torch autograd."""
    n, F = NN.shape
    covparms = torch.as_tensor(covparms, dtype=locs.dtype).to(locs.device)
    e0 = torch.zeros(F, dtype=locs.dtype, device=locs.device)
    e0[0] = 1.0
    out = []
    step = _chunk(F)
    for s in range(0, n, step):
        nn = NN[s:s + step].long()
        C, _ = _cov_chunk(locs, nn, valid[s:s + step], resp[s:s + step],
                          nug_point, covparms)
        out.append(_solve(C, e0.expand(len(nn), F)))
    if not out:
        return torch.empty(0, F, dtype=locs.dtype, device=locs.device)
    return torch.cat(out)


def matern_solve_e0_bwd_plain(locs, NN, valid, resp, nug_point, covparms, x,
                              xbar):
    """Plain version of H5: (dpar (n, 2) float64, dslot (n, F)); dpar is
    (n, 3) for the general Matern.

    With w = C^{-1} xbar, the cotangent of C is -w x^T; dpar[p] holds its
    contraction with dC/dsig2 = g(s), dC/drho = sig2 g'(s) (-s/rho) (and
    dC/dnu = sig2 dg/dnu) over the point's valid pairs, dslot[p, j] its
    diagonal entry at a valid response-conditioned slot (the cotangent of
    that slot's nugget)."""
    n, F = NN.shape
    cp = torch.as_tensor(covparms, dtype=locs.dtype).to(locs.device)
    sig2, rho, idx = cp[0], cp[1], nu_index(cp[2])
    dpar, dslot = [], []
    step = _chunk(F)
    for s in range(0, n, step):
        nn = NN[s:s + step].long()
        v, r = valid[s:s + step], resp[s:s + step]
        C, dist = _cov_chunk(locs, nn, v, r, nug_point, cp)
        w = _solve(C, xbar[s:s + step])
        gbar = -w[:, :, None] * x[s:s + step, None, :]
        gbar = torch.where(v[:, :, None] & v[:, None, :], gbar, 0.0)
        if idx == GENERAL:
            g, dgds, dgdnu = matern_general_dg(dist, rho, cp[2])
        else:
            g, dgds = matern_dgds(dist, rho, idx)
        sums = [(gbar * g).sum((1, 2), dtype=torch.float64),
                (gbar * sig2 * dgds * (-(dist / rho) / rho)).sum(
                    (1, 2), dtype=torch.float64)]
        if idx == GENERAL:
            sums.append((gbar * sig2 * dgdnu).sum((1, 2), dtype=torch.float64))
        dpar.append(torch.stack(sums, 1))
        dslot.append(torch.where(v & r, torch.diagonal(gbar, 0, 1, 2), 0.0))
    if not dpar:
        return (locs.new_zeros(0, 3 if idx == GENERAL else 2,
                               dtype=torch.float64), locs.new_zeros(0, F))
    return torch.cat(dpar), torch.cat(dslot)


def _check(locs, NN, valid, resp, nug_point, *vecs):
    n, F = NN.shape
    dev = locs.device
    for name, t in (("NN", NN), ("valid", valid), ("resp", resp),
                    ("nug_point", nug_point)) + tuple(
                        (f"vector {i}", v) for i, v in enumerate(vecs)):
        if t.device != dev:
            raise ValueError(f"matern_solve_e0: {name} on {t.device}, locs "
                             f"on {dev}")
    if locs.dim() != 2 or locs.dtype not in (torch.float32, torch.float64):
        raise TypeError("matern_solve_e0: locs must be (n_all, d) float32 or "
                        "float64")
    if NN.dtype != torch.int32 or valid.dtype != torch.bool \
            or resp.dtype != torch.bool:
        raise TypeError("matern_solve_e0: NN int32, valid/resp bool")
    if valid.shape != (n, F) or resp.shape != (n, F) \
            or nug_point.shape != (locs.shape[0],) \
            or nug_point.dtype != locs.dtype \
            or any(v.shape != (n, F) or v.dtype != locs.dtype for v in vecs):
        raise ValueError("matern_solve_e0: shape/dtype mismatch")


def _zero_rows(xbar):
    """(n, 1) mask of the points whose cotangent row is all zero: their
    contribution is exactly zero, also where their matrix is not SPD and the
    kernel's refactor gives NaN (a row the likelihood dropped)."""
    return torch.all(xbar == 0, dim=1, keepdim=True)


def _params(covparms, dtype):
    """(sig2, rho, nu_idx, gen): gen is None at a closed form, else the
    general Matern's ``general_params`` in ``dtype``."""
    cp = [float(c) for c in trace.sync(covparms).detach().cpu().tolist()]
    idx = nu_index(cp[2])
    gen = general_params(cp[2], dtype) if idx == GENERAL else None
    return cp[0], cp[1], idx, gen


def _device(name, t):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _stats_ptr(stats, F, dtype, gen, device):
    """The data pointer of a launch's ``stats`` (None: none); only the
    general instances on the shared-memory route count."""
    if stats is None:
        return None
    if gen is None or route(F, dtype) != "shared":
        raise ValueError("stats: only the general Matern's instances on the "
                         "shared-memory route count their pairs")
    if stats.shape != (len(STATS_FIELDS),) or stats.dtype != torch.int64 \
            or stats.device != device:
        raise ValueError(f"stats: int64 ({len(STATS_FIELDS)},) on {device}")
    return stats.data_ptr()


def _launch(locs, NN, valid, resp, nug_point, covparms, stats=None):
    """H1 on CUDA tensors; ``stats``: see ``STATS_FIELDS``."""
    n, F = NN.shape
    d = locs.shape[1]
    sig2, rho, nu_idx, gen = _params(covparms, locs.dtype)
    warps = _warps("matern_solve_e0", F, d, locs.dtype, _FWD_VECS,
                   max_neighbors(d, locs.dtype), gen is not None)
    locs, NN, valid, resp, nug_point = (
        t.contiguous() for t in (locs, NN, valid, resp, nug_point))
    x = torch.empty(n, F, dtype=locs.dtype, device=locs.device)
    args = (locs.data_ptr(), d, NN.data_ptr(), valid.data_ptr(),
            resp.data_ptr(), nug_point.data_ptr(), n, F, sig2, rho, nu_idx,
            None if gen is None else gen.ctypes.data, x.data_ptr())
    counts = _stats_ptr(stats, F, locs.dtype, gen, locs.device)
    if route(F, locs.dtype) == "registers":
        rc = cuda.entry("gpv_matern_solve_e0_regs", locs.dtype)(
            *args, cuda.stream(locs.device))
    else:
        rc = cuda.entry("gpv_matern_solve_e0", locs.dtype)(
            *args, counts, warps, cuda.stream(locs.device))
    cuda.check(rc, "matern_solve_e0")
    trace.count("launches.matern_solve_e0" if gen is None
                else "launches.matern_solve_e0[general]")
    return x


def _launch_bwd(locs, NN, valid, resp, nug_point, covparms, x, xbar,
                stats=None):
    """H5 on CUDA tensors; ``stats``: see ``STATS_FIELDS``."""
    n, F = NN.shape
    d = locs.shape[1]
    sig2, rho, nu_idx, gen = _params(covparms, locs.dtype)
    warps = _warps("matern_solve_e0_bwd", F, d, locs.dtype, _BWD_VECS,
                   max_neighbors(d, locs.dtype), gen is not None)
    locs, NN, valid, resp, nug_point, x, xbar = (
        t.contiguous() for t in (locs, NN, valid, resp, nug_point, x, xbar))
    dpar = torch.empty(n, 2 if gen is None else 3, dtype=torch.float64,
                       device=locs.device)
    dslot = torch.empty(n, F, dtype=locs.dtype, device=locs.device)
    args = (locs.data_ptr(), d, NN.data_ptr(), valid.data_ptr(),
            resp.data_ptr(), nug_point.data_ptr(), n, F, sig2, rho, nu_idx,
            None if gen is None else gen.ctypes.data, x.data_ptr(),
            xbar.data_ptr(), dpar.data_ptr(), dslot.data_ptr())
    counts = _stats_ptr(stats, F, locs.dtype, gen, locs.device)
    if route(F, locs.dtype) == "registers":
        rc = cuda.entry("gpv_matern_solve_e0_bwd_regs", locs.dtype)(
            *args, cuda.stream(locs.device))
    else:
        rc = cuda.entry("gpv_matern_solve_e0_bwd", locs.dtype)(
            *args, counts, warps, cuda.stream(locs.device))
    cuda.check(rc, "matern_solve_e0_bwd")
    trace.count("launches.matern_solve_e0_bwd" if gen is None
                else "launches.matern_solve_e0_bwd[general]")
    return dpar, dslot


def matern_solve_e0_bwd(locs, NN, valid, resp, nug_point, covparms, x, xbar):
    """(dcovparms, dnug_point): the VJP of ``matern_solve_e0`` at its
    solution x for the cotangent xbar (both (n, F)); a point whose xbar is
    0 contributes 0.  dcovparms has covparms' shape, device and dtype
    (d/dnu = 0 at the closed forms); dnug_point has nug_point's.  CPU
    tensors take the plain version, CUDA tensors H5."""
    _check(locs, NN, valid, resp, nug_point, x, xbar)
    if not torch.is_tensor(covparms):
        covparms = torch.tensor(covparms, dtype=torch.float64)
    if _device("matern_solve_e0_bwd", locs):
        dpar, dslot = _launch_bwd(locs, NN, valid, resp, nug_point, covparms,
                                  x, xbar)
    else:
        dpar, dslot = matern_solve_e0_bwd_plain(locs, NN, valid, resp,
                                                nug_point, covparms, x, xbar)
    return reduce_bwd(dpar, dslot, xbar, NN, resp, nug_point, covparms)


# the nugget gradient's schedules: id(NN) -> (a weak reference to NN, the
# schedule); an entry goes with its tensor
_SLOT_SUMS = {}


def reduce_bwd(dpar, dslot, xbar, NN, resp, nug_point, covparms):
    """(dcovparms, dnug_point) from H5's per-point outputs: a point whose
    xbar is 0 contributes 0 (also where its dpar and dslot are NaN: a row
    the likelihood dropped), the rest is summed in a fixed order, so the
    result is the same bit for bit from run to run.

    dnug_point[p] sums dslot over the response slots (``resp``, the only
    ones where dslot is not 0) with NN == p by a segment sum
    (``linalg.sparse.segment_sum``), never through colliding writes.  Its
    schedule (``plan.slot_sum_schedule``) is built once for each NN tensor
    (``_SLOT_SUMS``): one NN tensor always comes with one ``resp`` (a
    plan's NN and its response-conditioned slots)."""
    zero = _zero_rows(xbar)
    dpar = torch.where(zero, 0.0, dpar)
    dslot = torch.where(zero, 0.0, dslot)
    dcov = torch.zeros(covparms.shape, dtype=torch.float64, device=dpar.device)
    dcov[:dpar.shape[1]] = dpar.sum(0)
    ref, sched = _SLOT_SUMS.get(id(NN), (None, None))
    if ref is None or ref() is not NN:
        sched = device_schedule(
            slot_sum_schedule(trace.sync(NN).cpu().numpy(),
                              trace.sync(resp).cpu().numpy(),
                              nug_point.shape[0]), dslot.device, pairs=False)
        key = id(NN)
        _SLOT_SUMS[key] = (weakref.ref(
            NN, lambda _, key=key: _SLOT_SUMS.pop(key, None)), sched)
    dnug = segment_sum(dslot.reshape(-1), sched)
    return trace.to(dcov, covparms.device, covparms.dtype), dnug


class _MaternSolveE0(torch.autograd.Function):
    """x = C(covparms, nug_point)^{-1} e0 per point; backward through H5."""

    @staticmethod
    def forward(ctx, locs, NN, valid, resp, nug_point, covparms):
        if _device("matern_solve_e0", locs):
            x = _launch(locs, NN, valid, resp, nug_point, covparms)
        else:
            x = matern_solve_e0_plain(locs, NN, valid, resp, nug_point,
                                      covparms)
        ctx.save_for_backward(locs, NN, valid, resp, nug_point, covparms, x)
        return x

    @staticmethod
    @once_differentiable
    @trace.span("u_entries.bwd")
    def backward(ctx, xbar):
        locs, NN, valid, resp, nug_point, covparms, x = ctx.saved_tensors
        dcov, dnug = matern_solve_e0_bwd(locs, NN, valid, resp, nug_point,
                                         covparms, x, xbar)
        return None, None, None, None, dnug, dcov


def matern_solve_e0(locs, NN, valid, resp, nug_point, covparms):
    """x (n, F) with x[p] = C_p^{-1} e0, differentiable in ``nug_point`` and
    ``covparms``.

    locs: (n_all, d) coordinates; NN: (n, F) int32 neighbor ids (self
    first, clamped >= 0); valid: (n, F) bool; resp: (n, F) bool, the
    response-conditioned slots whose nugget ``nug_point[NN]`` is added on
    the diagonal; covparms: (sig2, rho, nu), any nu > 0, on any device.
    CPU tensors take the plain version, CUDA tensors the kernel (at a
    smoothness without closed form its general instance).
    """
    _check(locs, NN, valid, resp, nug_point)
    if not torch.is_tensor(covparms):
        covparms = torch.tensor(covparms, dtype=torch.float64)
    return _MaternSolveE0.apply(locs, NN, valid, resp, nug_point, covparms)


# ------------------------- H8: K3 on a given packed covariance ----

def packed_f(P: int) -> int:
    """F with F(F+1)/2 = P; ValueError if P is no such number."""
    F = int(round(((8 * P + 1) ** 0.5 - 1) / 2))
    if F * (F + 1) // 2 != P:
        raise ValueError(f"{P} is not a packed triangle size F(F+1)/2")
    return F


def _unpack(Cp, F):
    """(n, F, F) with the lower triangle of each packed upper triangle (the
    row-major order of the JAX package's packing); the rest is 0."""
    iu, ju = torch.triu_indices(F, F, device=Cp.device)
    C = Cp.new_zeros(Cp.shape[0], F, F)
    C[:, ju, iu] = Cp
    return C


def solve_e0_plain(Cp):
    """Plain version of H8: (n, F) solutions x = C^{-1} e0 of the packed
    (n, P) covariances, NaN rows where C is not SPD."""
    F = packed_f(Cp.shape[1])
    e0 = torch.zeros(F, dtype=Cp.dtype, device=Cp.device)
    e0[0] = 1.0
    return _solve(_unpack(Cp, F), e0.expand(Cp.shape[0], F))


def _launch_solve(Cp, F):
    n = Cp.shape[0]
    warps = _warps("solve_e0", F, 0, Cp.dtype, _FWD_VECS - 1,
                   _max_f(0, Cp.dtype, _FWD_VECS))
    Cp = Cp.contiguous()
    x = torch.empty(n, F, dtype=Cp.dtype, device=Cp.device)
    if route(F, Cp.dtype) == "registers":
        rc = cuda.entry("gpv_solve_e0_regs", Cp.dtype)(
            Cp.data_ptr(), n, F, x.data_ptr(), cuda.stream(Cp.device))
    else:
        rc = cuda.entry("gpv_solve_e0", Cp.dtype)(
            Cp.data_ptr(), n, F, x.data_ptr(), warps, cuda.stream(Cp.device))
    cuda.check(rc, "solve_e0")
    trace.count("launches.solve_e0")
    return x


def solve_e0(Cp):
    """H8, K3's counterpart: x (n, F) with x[p] = C_p^{-1} e0 for packed
    covariances Cp (n, P) point-major, P = F(F+1)/2, each row the upper
    triangle row by row.  A non-SPD C gives NaN/Inf in its own row only.
    CPU tensors take the plain version, CUDA tensors the kernel (up to the
    shared-memory bound of ``solve_e0_bwd``, its backward, so that a value
    is only computed where its gradient can be).  Not differentiable: see
    ``packed_solve_e0``."""
    if Cp.dim() != 2 or Cp.dtype not in (torch.float32, torch.float64):
        raise TypeError("solve_e0: Cp must be (n, P) float32 or float64")
    F = packed_f(Cp.shape[1])
    if _device("solve_e0", Cp):
        return _launch_solve(Cp, F)
    return solve_e0_plain(Cp)


class _PackedSolveE0(torch.autograd.Function):
    """H8 forward, ``solve_e0_bwd`` (K2) backward: ``_make_solver`` of the
    JAX package's ``kernels/pallas_crout.py``."""

    @staticmethod
    def forward(ctx, Cp):
        x = solve_e0(Cp)
        ctx.save_for_backward(Cp, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, xbar):
        Cp, x = ctx.saved_tensors
        return solve_e0_bwd(Cp, x, xbar.contiguous())


def packed_solve_e0(Cp):
    """x = C^{-1} e0 for packed point-major covariances (n, P) -> (n, F),
    differentiable in Cp (the backward is K2's packed cotangent)."""
    return _PackedSolveE0.apply(Cp)


# ------------------------------------------------- K2 one to one ----

def solve_e0_bwd_plain(Cp, x, xbar):
    """Plain version of ``solve_e0_bwd``: K2's packed cotangent (n, P)."""
    n, F = x.shape
    iu, ju = torch.triu_indices(F, F, device=Cp.device)
    w = _solve(_unpack(Cp, F), xbar)
    g = -(w[:, iu] * x[:, ju] + w[:, ju] * x[:, iu])
    return torch.where(iu == ju, 0.5 * g, g)


def _launch_solve_bwd(Cp, x, xbar):
    n, F = x.shape
    warps = _warps("solve_e0_bwd", F, 0, Cp.dtype, _FWD_VECS,
                   _max_f(0, Cp.dtype, _FWD_VECS))
    Cp, x, xbar = (t.contiguous() for t in (Cp, x, xbar))
    g = torch.empty_like(Cp)
    args = (Cp.data_ptr(), n, F, x.data_ptr(), xbar.data_ptr(), g.data_ptr())
    if route(F, Cp.dtype) == "registers":
        rc = cuda.entry("gpv_solve_e0_bwd_regs", Cp.dtype)(
            *args, cuda.stream(Cp.device))
    else:
        rc = cuda.entry("gpv_solve_e0_bwd", Cp.dtype)(
            *args, warps, cuda.stream(Cp.device))
    cuda.check(rc, "solve_e0_bwd")
    trace.count("launches.solve_e0_bwd")
    return g


def solve_e0_bwd(Cp, x, xbar):
    """K2: the packed cotangent of Cp for x = C^{-1} e0, given x and xbar.

    Cp: (n, P) packed upper triangles, point-major, P = F(F+1)/2; x, xbar:
    (n, F).  Returns gbar (n, P) with gbar[i<j] = -(w_i x_j + w_j x_i) and
    gbar[i, i] = -w_i x_i, w = C^{-1} xbar, and 0 in the rows whose xbar
    is 0.  CPU tensors take the plain version, CUDA tensors the kernel."""
    n, F = x.shape
    if Cp.shape != (n, F * (F + 1) // 2) or xbar.shape != (n, F) \
            or x.dtype != Cp.dtype or xbar.dtype != Cp.dtype \
            or x.device != Cp.device or xbar.device != Cp.device:
        raise ValueError("solve_e0_bwd: shape/dtype/device mismatch")
    if _device("solve_e0_bwd", Cp):
        g = _launch_solve_bwd(Cp, x, xbar)
    else:
        g = solve_e0_bwd_plain(Cp, x, xbar)
    return torch.where(_zero_rows(xbar), 0.0, g)
