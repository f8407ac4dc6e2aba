"""MRA conditioning sets (Katzfuss and Gong, Environmetrics 2020) at
GPvecchia's default options, for maxmin-ordered locations: a frozen
restatement of the default path of GPvecchia's ``choose.M`` and
``findOrderedNN_mra`` / ``fastTree`` knot tree (R/mraNN.r,
src/fastTree.cpp), in NumPy.

Resolution 0 is the whole domain; at each resolution a region's first
r[l] points (in ordering position) are its knots, and the rest is split
into J[l] = 2 halves by median cuts on alternating coordinates; at the
finest resolution every point of a region is a knot.  A knot conditions
on itself and on every earlier knot along its chain of ancestor regions,
the most recent first.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np


def choose_M(n: int, m: int):
    """(M, r, J) of GPvecchia's ``choose.M`` for m > 1."""
    M = 1
    while 2 ** M / M <= n / m:
        M += 1
    if M + 1 > m:
        M = m - 1
        r = [1] * (M + 1)
        last = 2 ** math.ceil(math.log2(
            (n - sum(2 ** k for k in range(M))) / 2 ** (M - 1)))
        J = [2] * max(M - 1, 0) + [last]
    else:
        J = [2] * M
        r = [math.ceil(m / (M + 1))] * (M + 1)
        level = 0
        while sum(r) > m:
            r[level] -= 1
            level += 1
    if sum(r) > m or int(np.sum(np.asarray(r) * np.cumprod([1] + J))) < n:
        raise ValueError("no valid MRA parameters")
    return M, r, J


def split(locs, inds, K, dim_start):
    """K (a power of two) regions of balanced size by median cuts, points
    on a median shared to balance the halves; each ascending."""
    regions = [np.asarray(inds, dtype=np.int64)]
    for power in range(int(math.log2(K))):
        d = (dim_start + power) % locs.shape[1]
        nxt = []
        for reg in regions:
            vals = locs[reg, d]
            cut = np.median(vals)
            hi, lo, mid = reg[vals > cut], reg[vals < cut], reg[vals == cut]
            if mid.size:
                take = min(abs(hi.size - lo.size), mid.size)
                if hi.size > lo.size:
                    lo = np.concatenate([lo, mid[:take]])
                else:
                    hi = np.concatenate([hi, mid[:take]])
                rest = mid[take:]
                hi = np.concatenate([hi, rest[:rest.size // 2]])
                lo = np.concatenate([lo, rest[rest.size // 2:]])
            nxt += [hi, lo]
        regions = nxt
    return [np.sort(r) for r in regions]


def mra_nn(locsord, m):
    """(n, eff_m + 1) int64 conditioning sets, self first, -1 padded."""
    n = locsord.shape[0]
    M, r, J = choose_M(n, m)
    cond = [None] * n
    queue = deque([(0, np.empty(0, dtype=np.int64),
                    np.arange(n, dtype=np.int64))])
    while queue:
        level, chain, reg = queue.popleft()
        knots = reg[:min(r[level], reg.size)] if level < M else reg
        for k in knots:
            chain = np.concatenate([[k], chain])
            cond[int(k)] = chain
        rest = reg[knots.size:]
        if level >= M or rest.size == 0:
            continue
        if J[level] > rest.size:
            kids = [rest[i:i + 1] for i in range(rest.size)]
            kids += [np.empty(0, dtype=np.int64)] * (J[level] - rest.size)
        else:
            kids = split(locsord, rest, J[level], level % 2 + 1)
        for kid in kids:
            queue.append((level + 1, chain, kid))
    width = max(c.size for c in cond)
    NN = np.full((n, width), -1, dtype=np.int64)
    for p, c in enumerate(cond):
        NN[p, :c.size] = c
    return NN
