"""The plain reference that decides ``correct``: NumPy, SciPy's k-d tree
and plain torch, importing nothing of the measured package.  It works out
the specification (``spec.py``), the elimination of the latent precision
(``factor.py``) and the likelihood with its gradient (``likelihood.py``)
again from the configuration's locations, the run's observations and the
step's parameters."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import factor, mra, spec
from .likelihood import Problem

LEAF_COLUMNS = 128        # columns a leaf of the elimination tree, about


def depth_of(n):
    return max(0, int(round(math.log2(max(n, 1) / LEAF_COLUMNS))))


def build(locs, config, device):
    """{name: array}: the ordering, conditioning sets and latent flags of
    the configuration's spec, and the levels of the factor.  Supports
    ``cond_yz="SGV"`` with nearest-neighbour conditioning, and MRA
    conditioning at its default options."""
    sp = config["specify"]
    if sp.get("conditioning", "NN") == "mra" and "cond_yz" not in sp:
        # MRA: maxmin ordering, the knot tree's sets, every neighbour
        # conditioned on through its latent
        ordv = spec.maxmin_order(locs)
        locsord = np.ascontiguousarray(locs[ordv])
        NN = mra.mra_nn(locsord, int(sp["m"]))
        cond = NN >= 0
    elif sp.get("cond_yz") == "SGV" and sp.get("conditioning", "NN") == "NN":
        ordv, locsord, NN, cond = spec.sgv_spec(locs, int(sp["m"]), device)
    else:
        raise NotImplementedError(f"the reference has no spec {sp}")
    levels = factor.build_tree(locsord, NN, cond, depth_of(locs.shape[0]))
    out = {"ord": ordv, "NN": NN.astype(np.int32), "cond": cond,
           "n_levels": np.array(len(levels))}
    for d, lv in enumerate(levels):
        for f in dataclasses.fields(lv):
            v = getattr(lv, f.name)
            if v is not None:
                v = np.asarray(v)
                if v.dtype == np.int64 and v.size and v.max() < 2 ** 31:
                    v = v.astype(np.int32)
                out[f"L{d}.{f.name}"] = v
    return out


def problem(arrays, locs, z, device):
    """The reference's ``Problem`` from ``build``'s arrays, the locations
    and the observations z (numpy, the locations' order)."""
    levels = []
    for d in range(int(arrays["n_levels"])):
        kw = {f.name: arrays.get(f"L{d}.{f.name}")
              for f in dataclasses.fields(factor.Level)}
        for f in ("N", "P", "S", "C"):
            kw[f] = int(kw[f])
        levels.append(factor.Level(**kw))
    ordv = arrays["ord"]
    return Problem(locs[ordv], arrays["NN"], arrays["cond"], z[ordv], levels,
                   device)
