"""Multi-resolution (hierarchical) conditioning sets (host-side, NumPy).

Builds the MRA knot tree over maxmin-ordered locations: at each resolution
level, the first ``r[level]`` points of a region (in ordering position) become
knots; the remainder is split into ``J[level]`` balanced halves by median cuts
along alternating coordinates.  A knot's conditioning set is itself plus all
previously-indexed knots along its ancestor path.

A copy of the JAX package's ``geometry/mra.py``: that module imports no
JAX, but the port imports nothing of that package.
``tests/test_torch_mra.py`` holds the two equal array for array.

Reference parity targets (behavior, not code):
  - choose.M / choose.M.decay     ~ GPvecchia R/mraNN.r:7-65
  - get.mra.params                ~ GPvecchia R/mraNN.r:70-110
  - findOrderedNN_mra             ~ GPvecchia R/mraNN.r:116-143
  - clusterEqual / knotTree / getNNmatrix ~ GPvecchia src/fastTree.cpp:19-268
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

__all__ = ["choose_M", "get_mra_params", "cluster_equal", "build_mra_nnarray",
           "find_ordered_nn_mra"]


def choose_M(n: int, m: int) -> dict:
    """Derive (M, r, J) from (n, m)."""
    if m == 1:
        return {"r": [1], "J": [2 ** math.ceil(math.log2(max(n - 1, 1)))], "M": 1}

    M = 1
    while 2 ** M / M <= n / m:
        M += 1

    if M + 1 > m:  # very small m
        M = m - 1
        r = [1] * (M + 1)
        last_J = 2 ** math.ceil(math.log2((n - sum(2 ** k for k in range(M))) / 2 ** (M - 1)))
        J = [2] * max(M - 1, 0) + [last_J]
    else:
        J = [2] * M
        r = [math.ceil(m / (M + 1))] * (M + 1)
        l = 0
        while sum(r) > m:
            r[l] -= 1
            l += 1

    cum = np.cumprod([1] + list(J))
    if sum(r) > m or int(np.sum(np.asarray(r) * cum)) < n:
        raise ValueError("couldn't find valid mra parameters")
    return {"M": M, "r": r, "J": J}


def get_mra_params(n: int, opts: dict | None, m: int) -> dict:
    """Reconcile user-provided mra options with defaults.

    Mirrors the special cases: independent blocks r=(0,m), low-rank r=(m,1).
    """
    opts = dict(opts or {})
    r_opt = opts.get("r")
    J_opt = opts.get("J")
    M_opt = opts.get("M")

    # set J first
    if J_opt is None and M_opt is None:
        if r_opt is not None and len(list(np.atleast_1d(r_opt))) == 2:
            r_arr = list(np.atleast_1d(r_opt))
            if r_arr[0] == 0:  # independent blocks
                J = 2 ** math.ceil(math.log2(n / r_arr[1]))
            elif r_arr[1] == 1:  # low rank / modified predictive process
                J = 2 ** math.ceil(math.log2(max(n - r_arr[0], 1)))
            else:
                J = 2
        else:
            J = 2
    elif M_opt is None:
        J = 2 ** math.ceil(math.log2(J_opt))
    else:
        J = 2

    # set M and r
    if M_opt is None:
        if r_opt is None:
            pars = choose_M(n, m)
            r, M, J = pars["r"], pars["M"], pars["J"]
        else:
            r = list(np.atleast_1d(r_opt))
            if len(r) > 1:
                M = len(r) - 1
            elif np.ndim(J) > 0 and len(np.atleast_1d(J)) > 1:
                M = len(np.atleast_1d(J))
            else:
                M = math.floor((math.log(n / r[0]) * (J - 1) + 1) / math.log(J)) - 1
    elif r_opt is None:
        M = M_opt
        r = [math.ceil(m / (M + 1))] * (M + 1)
        if J_opt is None:
            last_J = 2 ** (math.ceil(math.log2((n - r[0] * (2 ** M - 1)) / r[0])) - (M - 1))
            J = [2] * (M - 1) + [last_J]
    else:
        M = M_opt
        r = list(np.atleast_1d(r_opt))
        if J_opt is not None:
            J = 2 ** math.ceil(math.log2(J_opt))

    J_list = list(np.atleast_1d(J))
    if len(J_list) == 1:
        J_list = J_list * M
    r_list = list(np.atleast_1d(r))
    if len(r_list) == 1:
        r_list = r_list * (M + 1)
    return {"m": m, "M": int(M), "J": [int(j) for j in J_list], "r": [int(x) for x in r_list]}


def cluster_equal(locs: np.ndarray, inds: np.ndarray, K: int, dim_start: int) -> list[np.ndarray]:
    """Split a region into K (power of two) balanced clusters by median cuts.

    ``inds`` are indices into ``locs``; returns a list of K index arrays.
    Border points (exactly at the median) are distributed to balance halves.
    """
    K = 2 ** math.ceil(math.log2(K))
    d_total = locs.shape[1]
    regions = [np.asarray(inds, dtype=np.int64)]
    for power in range(int(math.log2(K))):
        new_regions = []
        d = (dim_start + power) % d_total
        for reg in regions:
            vals = locs[reg, d]
            cutoff = np.median(vals)
            r1 = reg[vals > cutoff]
            r2 = reg[vals < cutoff]
            border = reg[vals == cutoff]
            if border.size > 0:
                diff = abs(int(r1.size) - int(r2.size))
                take = min(diff, border.size)
                if r1.size > r2.size:
                    r2 = np.concatenate([r2, border[:take]])
                else:
                    r1 = np.concatenate([r1, border[:take]])
                rest = border[take:]
                half = rest.size // 2
                r1 = np.concatenate([r1, rest[:half]])
                r2 = np.concatenate([r2, rest[half:]])
            new_regions.append(r1)
            new_regions.append(r2)
        regions = new_regions
    # children keep ascending ordering-position order (the reference assigns
    # cluster labels per position, fastTree.cpp:78-85, so region index lists
    # stay sorted); sort to match
    return [np.sort(r) for r in regions]


def build_mra_nnarray(locsord: np.ndarray, J: list[int], M: int, r: list[int],
                      force_python: bool = False):
    """BFS knot tree -> conditioning sets.

    Returns (NNarray, eff) where NNarray is (n, eff_m+1) int64, self first,
    -1 padded, and eff is a dict of effective M/J/r.  Uses the native C++
    knot-tree construction (csrc/hostops.cpp mra_tree; GPvecchia
    src/fastTree.cpp:272-297) when available — the Python BFS below is its
    behavioral twin and the fallback (force_python pins it for parity
    tests).
    """
    locsord = np.asarray(locsord, dtype=np.float64)
    n = locsord.shape[0]

    native = None
    if not force_python:
        from ..csrc.host import mra_tree
        native = mra_tree(locsord, J, M, r)
    if native is not None:
        chain_next, chain_len, eff_part = native
        eff_m = int(chain_len.max()) - 1
        NNarray = np.full((n, eff_m + 1), -1, dtype=np.int64)
        cur = np.arange(n, dtype=np.int64)
        NNarray[:, 0] = cur
        cur = chain_next.copy()
        for k in range(1, eff_m + 1):
            ok = cur >= 0
            NNarray[ok, k] = cur[ok]
            cur[ok] = chain_next[cur[ok]]
        eff = {"M": eff_part["M"], "J": [int(j) for j in J],
               "r": eff_part["r"], "m": eff_m}
        return NNarray, eff

    # cond_of[p] for each point p = its full conditioning set (self first,
    # most recent ancestor-knots next), as a list
    cond_of: dict[int, np.ndarray] = {}
    eff_M = 0
    eff_r = [0] * (M + 1)
    eff_r_conflict = [False] * (M + 1)
    finest_count = 0
    finest_total = 0

    # queue of (level, parent_chain, region_inds); parent_chain = conditioning
    # set inherited from the last knot of the parent node (ancestors list)
    queue: deque = deque()
    queue.append((0, np.empty(0, dtype=np.int64), np.arange(n, dtype=np.int64)))

    while queue:
        level, chain, reg = queue.popleft()
        eff_M = max(eff_M, level)
        if level < M:
            r_eff = min(r[level], reg.size)
            if eff_r[level] == 0 and not eff_r_conflict[level]:
                eff_r[level] = r_eff
            elif eff_r[level] != r_eff:
                eff_r_conflict[level] = True
            knots = reg[:r_eff]
            rest = reg[r_eff:]
            new_chain = chain
            for k in knots:
                new_chain = np.concatenate([[k], new_chain])
                cond_of[int(k)] = new_chain
            if rest.size == 0:
                continue
            if J[level] > rest.size:
                clusters = [rest[i:i + 1] for i in range(rest.size)]
                clusters += [np.empty(0, dtype=np.int64)] * (J[level] - rest.size)
            else:
                dim_start = level % 2 + 1
                clusters = cluster_equal(locsord, rest, J[level], dim_start)
            for child in clusters:
                queue.append((level + 1, new_chain, child))
        else:
            new_chain = chain
            for k in reg:
                new_chain = np.concatenate([[k], new_chain])
                cond_of[int(k)] = new_chain
            finest_count += 1
            finest_total += reg.size

    eff_m = max((v.size for v in cond_of.values()), default=1) - 1
    NNarray = np.full((n, eff_m + 1), -1, dtype=np.int64)
    for p, cset in cond_of.items():
        NNarray[p, :cset.size] = cset

    if finest_count > 0:
        eff_r[M] = finest_total // finest_count
    eff = {"M": eff_M, "J": [int(j) for j in J],
           "r": [(-1 if eff_r_conflict[i] else eff_r[i]) for i in range(M + 1)],
           "m": eff_m}
    return NNarray, eff


def find_ordered_nn_mra(locsord: np.ndarray, mra_options: dict | None, m: int,
                        verbose: bool = False):
    """MRA conditioning sets for ordered locations; returns (NNarray, eff_m)."""
    n = locsord.shape[0]
    params = get_mra_params(n, mra_options, m)
    NNarray, eff = build_mra_nnarray(locsord, params["J"], params["M"], params["r"])
    eff_m = NNarray.shape[1] - 1
    if eff_m > 100:
        print(f"Effective m is {eff_m} which might slow down computations")
    if verbose:
        print(f"MRA params: m={eff_m}; J={eff['J']}; r={eff['r']}; M={eff['M']}")
    elif eff_m != m:
        print(f"info: effective m is {eff_m}")
    return NNarray, eff_m
