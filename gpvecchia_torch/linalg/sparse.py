"""Gathers with -1 padding and the scatter-free pair sum, in PyTorch.

The counterpart of the JAX package's ``linalg/sparse.py`` (``gather0``,
``pair_sum``).  ``pair_sum`` stands in for a scatter-add with colliding
indices: the host transposes each scatter map into per-target gather lists
padded by count class (``plan._build_pair_sum``), so the device does padded
gathers, a sum over the last axis and one gather back into target order.
No value is ever summed through colliding writes (``index_add_``,
``scatter_add_``, ``index_put_(accumulate=True)``), whose order on CUDA is
not fixed: the values are the same bit for bit from run to run.

Pads read zeros appended to the gathered array.  Gathers use advanced
indexing, whose backward on CUDA sorts the indices and sums each target's
run in a fixed order (``torch.gather`` and ``index_select`` would sum their
backward through atomics); one warp walks a run, so a long run of one index
is slow.  ``spread_pads`` therefore gives each pad of one gather a zero of
its own: a backward then meets only the runs of real reuse.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

__all__ = ["with_zeros", "gather0", "spread_pads", "Schedule",
           "device_schedule", "pair_sum", "segment_sum"]


def with_zeros(arr, count=1):
    """``arr`` with ``count`` zero rows appended along dim 0."""
    return torch.cat([arr, arr.new_zeros((count,) + arr.shape[1:])])


def gather0(arr, idx):
    """arr[idx] with idx == -1 yielding 0."""
    return with_zeros(arr)[idx]


def spread_pads(idx, base, lead=1):
    """(idx with its -1 pads replaced by distinct indices from ``base`` on,
    the count of them a gather needs): the array's first ``lead`` axes
    index gathers (levels) and each gather's pads get base + their flat
    position in it, so the array gathered from needs that many zeros
    appended after ``base`` values."""
    idx = np.asarray(idx, dtype=np.int64)
    per = int(np.prod(idx.shape[lead:], dtype=np.int64))
    pos = base + np.arange(per, dtype=np.int64).reshape(idx.shape[lead:])
    return np.where(idx < 0, pos, idx), max(per, 1)


class Schedule(typing.NamedTuple):
    """A pair-sum schedule on a device: the buckets' (pa, pb) (or pa alone),
    the gather back into target order, and the zeros appended to A, to B
    and to the parts (the -1 pads' and the empty targets' zeros)."""
    buckets: list
    gather_map: torch.Tensor | None
    za: int = 1
    zb: int = 1
    zs: int = 1


def device_schedule(sched, device, pairs=True, sizes=None):
    """A ``plan.PairSumSchedule`` on ``device`` as a ``Schedule`` of long
    tensors (``pairs=False``: pa alone, for ``segment_sum``).  ``sizes`` =
    (len(A), len(B)) spreads the pads and the empty targets over zeros of
    their own (``spread_pads``: a backward through the gathers meets no
    long run of one index); without it every pad reads one zero."""
    if sched is None:
        return Schedule([], None)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device,
                                                            torch.long)

    gmap = np.asarray(sched.gather_map, dtype=np.int64)
    if sizes is None:
        return Schedule([(t(b.pa), t(b.pb)) if pairs else t(b.pa)
                         for b in sched.buckets], t(gmap))
    buckets, za, zb = [], 1, 1
    for b in sched.buckets:
        pa, ka = spread_pads(b.pa, sizes[0], lead=0)
        pb, kb = spread_pads(b.pb, sizes[1], lead=0)
        buckets.append((t(pa), t(pb)) if pairs else t(pa))
        za, zb = max(za, ka), max(zb, kb)
    # targets with no source read the sentinel zeros after the parts
    pos = sum(b.pa.shape[0] for b in sched.buckets)
    empty = gmap == pos
    gmap = gmap.copy()
    gmap[empty] = pos + np.arange(int(empty.sum()))
    return Schedule(buckets, t(gmap), za, zb, max(int(empty.sum()), 1))


def pair_sum(A, B, sched):
    """out[t] = sum_c A[pa[t, c]] * B[pb[t, c]] (pads read 0).

    ``sched`` is ``device_schedule``'s: each bucket gives a contiguous
    count-class segment of parts; their concatenation with the sentinel
    zeros goes back into target order by one gather."""
    A0, B0 = with_zeros(A, sched.za), with_zeros(B, sched.zb)
    parts = [torch.sum(A0[pa] * B0[pb], dim=-1) for pa, pb in sched.buckets]
    return torch.cat(parts + [A.new_zeros(sched.zs)])[sched.gather_map]


def segment_sum(vals, sched):
    """out[t] = sum_c vals[pa[t, c]] (pads read 0), in a fixed order;
    ``sched`` is ``device_schedule(..., pairs=False)``'s."""
    v0 = with_zeros(vals, sched.za)
    parts = [torch.sum(v0[pa], dim=-1) for pa in sched.buckets]
    return torch.cat(parts + [vals.new_zeros(sched.zs)])[sched.gather_map]
