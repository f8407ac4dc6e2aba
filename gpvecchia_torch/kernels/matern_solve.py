"""H1 ``matern_solve_e0``: per point, x = C^{-1} e0 for the closed-form
Matern covariance C of its conditioning set.

Replaces the TPU kernel ``gpvecchia_tpu/kernels/pallas_crout.py``
``_fused_kernel`` (``pallas_call`` at :268, entry ``fused_matern_solve``).
The CUDA kernel is ``csrc/matern_solve.cu``: one warp per point with the
point's matrix in shared memory; it is bound by the serial pivot chain of
each warp, not by memory (see the source note there).  ``matern_solve_e0_plain`` is the plain PyTorch
version: batched ``torch.linalg.cholesky_ex`` and ``cholesky_solve``.
"""

from __future__ import annotations

import torch

from ..csrc import cuda
from .covariance import matern, nu_index, safe_dist

__all__ = ["matern_solve_e0", "matern_solve_e0_plain", "max_neighbors"]

_SMEM_PER_BLOCK = 48 * 1024     # static-launch shared-memory bound
_MAX_WARPS = 8


def _smem_per_warp(F: int, d: int, itemsize: int) -> int:
    return (F * F + F * d + 3 * F) * itemsize


def max_neighbors(d: int, dtype: torch.dtype) -> int:
    """Largest F = m+1 the kernel takes: one warp's F x F matrix, F x d
    coordinates and three F-vectors must fit 48 KB of shared memory."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    F = 1
    while _smem_per_warp(F + 1, d, itemsize) <= _SMEM_PER_BLOCK:
        F += 1
    return F


def matern_solve_e0_plain(locs, NN, valid, resp, nug_point, covparms):
    """Plain PyTorch version: (n, F) solutions, NaN rows where the
    conditioning covariance is not SPD."""
    n, F = NN.shape
    covparms = torch.as_tensor(covparms, dtype=locs.dtype).to(locs.device)
    row_chunk = max(1, (1 << 23) // (F * F))    # ~8M matrix entries per chunk
    eye = torch.eye(F, dtype=locs.dtype, device=locs.device)
    e0 = torch.zeros(F, 1, dtype=locs.dtype, device=locs.device)
    e0[0] = 1.0
    out = []
    for s in range(0, n, row_chunk):
        nn = NN[s:s + row_chunk].long()
        v = valid[s:s + row_chunk]
        pts = locs[nn]                                      # (c, F, d)
        diff = pts[:, :, None, :] - pts[:, None, :, :]
        C = matern(safe_dist((diff * diff).sum(-1)), covparms)
        nug = torch.where(resp[s:s + row_chunk], nug_point[nn], 0.0)
        C = C + torch.diag_embed(nug)
        C = torch.where(v[:, :, None] & v[:, None, :], C, eye)
        L, info = torch.linalg.cholesky_ex(C)
        x = torch.cholesky_solve(e0.expand(len(nn), F, 1), L)[..., 0]
        out.append(torch.where((info != 0)[:, None], torch.nan, x))
    if not out:
        return torch.empty(0, F, dtype=locs.dtype, device=locs.device)
    return torch.cat(out)


def _check(locs, NN, valid, resp, nug_point):
    n, F = NN.shape
    dev = locs.device
    for name, t in (("NN", NN), ("valid", valid), ("resp", resp),
                    ("nug_point", nug_point)):
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
            or nug_point.dtype != locs.dtype:
        raise ValueError("matern_solve_e0: shape/dtype mismatch")


def _launch(locs, NN, valid, resp, nug_point, covparms):
    n, F = NN.shape
    d = locs.shape[1]
    itemsize = locs.element_size()
    per_warp = _smem_per_warp(F, d, itemsize)
    if per_warp > _SMEM_PER_BLOCK:
        raise ValueError(
            f"matern_solve_e0: F={F} exceeds the shared-memory bound "
            f"F <= {max_neighbors(d, locs.dtype)} for d={d}, {locs.dtype}")
    warps = max(1, min(_MAX_WARPS, _SMEM_PER_BLOCK // per_warp))
    cp = [float(c) for c in covparms.detach().cpu().tolist()]
    nu_idx = nu_index(cp[2])
    tensors = [t.contiguous() for t in (locs, NN, valid, resp, nug_point)]
    locs, NN, valid, resp, nug_point = tensors
    x = torch.empty(n, F, dtype=locs.dtype, device=locs.device)
    rc = cuda.entry("gpv_matern_solve_e0", locs.dtype)(
        locs.data_ptr(), d, NN.data_ptr(), valid.data_ptr(), resp.data_ptr(),
        nug_point.data_ptr(), n, F, cp[0], cp[1], nu_idx, x.data_ptr(), warps,
        cuda.stream(locs.device))
    cuda.check(rc, "matern_solve_e0")
    matern_solve_e0.launches += 1
    return x


def matern_solve_e0(locs, NN, valid, resp, nug_point, covparms):
    """x (n, F) with x[p] = C_p^{-1} e0.

    locs: (n_all, d) coordinates; NN: (n, F) int32 neighbor ids (self
    first, clamped >= 0); valid: (n, F) bool; resp: (n, F) bool, the
    response-conditioned slots whose nugget ``nug_point[NN]`` is added on
    the diagonal; covparms: (sig2, rho, nu) with nu in {0.5, 1.5, 2.5}.
    CPU tensors take the plain version, CUDA tensors the kernel.
    """
    _check(locs, NN, valid, resp, nug_point)
    if not torch.is_tensor(covparms):
        covparms = torch.tensor(covparms, dtype=torch.float64)
    if locs.device.type == "cpu":
        return matern_solve_e0_plain(locs, NN, valid, resp, nug_point,
                                     covparms)
    if locs.device.type != "cuda":
        raise ValueError(f"matern_solve_e0: unsupported device {locs.device}")
    return cuda.KernelCall.apply("matern_solve_e0", _launch, -1, locs, NN,
                                 valid, resp, nug_point, covparms)


matern_solve_e0.launches = 0
