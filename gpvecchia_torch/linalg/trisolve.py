"""Level-scheduled sparse triangular solves on the V factor, in PyTorch.

The counterpart of the JAX package's ``linalg/trisolve.py``.  V is lower
triangular in reversed ordering; its values live in the plan's PHYSICAL
level-ordered layout (``plan.ensure_v``).  The unknown x lives in a
level-ordered physical layout too, so each level writes one contiguous
slice: gathers, dense reductions and contiguous writes only, no scatter.

  forward  (V x = b):   x_j = (b_j - sum_k V[j,k] x_k) / V[j,j]  over row j
  backward (V^T x = b): x_j = (b_j - sum_i V[i,j] x_i) / V[j,j]  over col j

(GPvecchia R/vecchia_likelihood.R:88, R/vecchia_prediction.R:122-126.)
The right-hand side is (n,) or (n, k): k columns solve in one pass, where
the JAX package vmaps.  The JAX package scans each bucket of levels; here
each level is a step of a Python loop over views of the bucket's index
tensors, which ``device_blocks`` puts on the device once.

Pads: each level solves its real columns only (they lead the level; the
physical x's pad positions stay exactly 0, so it is safe to reduce over,
``sum(x * x)``), and the pads of a real column's row list read zeros
appended to V and to x, a distinct zero for each pad of a level
(``sparse.spread_pads``: their backward meets no long run of one index).
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .sparse import spread_pads, with_zeros

__all__ = ["Solve", "device_blocks", "forward_solve", "backward_solve"]


class Solve(typing.NamedTuple):
    """A solve schedule on a device: per bucket (cols, V slots, x rows or
    row columns, offsets, real column counts), the physical x size, and
    the zeros appended to V and to x."""
    kind: str
    blocks: list
    x_size: int
    zv: int
    zx: int


def device_blocks(blocks, device, kind, v_size, x_size):
    """A plan's ``FwdBlock`` (kind 'fwd') or ``SolveBlock`` ('bwd') list on
    ``device`` as a ``Solve``.  ``v_size`` is V's physical size and
    ``x_size`` the solve's physical x size: the pads of V slots and x rows
    go to zeros appended after them (``spread_pads``)."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device,
                                                            torch.long)

    out, zv, zx = [], 1, 1
    for b in blocks:
        nreal = (b.cols >= 0).sum(axis=1).tolist()
        if kind == "fwd":
            rs, kv = spread_pads(b.row_slots, v_size)
            rc, kx = spread_pads(b.row_cols, x_size)
            out.append((t(b.cols), t(b.diag_slots), t(rs), t(rc),
                        b.offsets.tolist(), nreal))
        else:
            sl, kv = spread_pads(b.slots, v_size)
            rw, kx = spread_pads(b.rows, x_size)
            out.append((t(b.cols), t(sl), t(rw), b.offsets.tolist(), nreal))
        zv, zx = max(zv, kv), max(zx, kx)
    return Solve(kind, out, x_size, zv, zx)


def _finish(x, x_size, x_perm):
    x = x[:x_size]
    return x if x_perm is None else x[x_perm]


def _dot(vv, xx):
    """sum_r vv[l, r] * xx[l, r] over r; xx (L, R) or (L, R, k)."""
    if xx.dim() == 2:
        return torch.sum(vv * xx, dim=1)
    return torch.bmm(vv[:, None, :], xx)[:, 0]


def forward_solve(v_flat, b, solve, x_perm=None):
    """Solve V x = b; b (n,) or (n, k) in logical (reversed-latent) order,
    ``solve`` from ``device_blocks(..., 'fwd', ...)``.  Returns x in logical
    order if ``x_perm`` (a long tensor) is given, otherwise in the padded
    physical layout (x_size rows, pads exactly 0)."""
    v = with_zeros(v_flat, solve.zv)
    x = b.new_zeros((solve.x_size + solve.zx,) + b.shape[1:])
    tail = (...,) + (None,) * (b.dim() - 1)
    for cols, dslots, rslots, rcols, offsets, nreal in solve.blocks:
        for li, (off, k) in enumerate(zip(offsets, nreal)):
            bj = b[cols[li, :k]]
            if rslots.shape[-1] > 0:
                bj = bj - _dot(v[rslots[li, :k]], x[rcols[li, :k]])
            x[off:off + k] = bj / v[dslots[li, :k]][tail]
    return _finish(x, solve.x_size, x_perm)


def backward_solve(v_flat, b, solve, x_perm=None):
    """Solve V^T x = b; b (n,) or (n, k) in logical order, ``solve`` from
    ``device_blocks(..., 'bwd', ...)``; outputs as ``forward_solve``'s."""
    v = with_zeros(v_flat, solve.zv)
    x = b.new_zeros((solve.x_size + solve.zx,) + b.shape[1:])
    tail = (...,) + (None,) * (b.dim() - 1)
    for cols, slots, rows, offsets, nreal in solve.blocks:
        for li, (off, k) in enumerate(zip(offsets, nreal)):
            vals = v[slots[li, :k]]
            bj = b[cols[li, :k]]
            if vals.shape[-1] > 1:
                bj = bj - _dot(vals[:, 1:], x[rows[li, :k, 1:]])
            x[off:off + k] = bj / vals[:, 0][tail]
    return _finish(x, solve.x_size, x_perm)
