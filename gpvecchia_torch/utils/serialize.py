"""Spec serialization: save/load the parameter-free VecchiaSpec as .npz.

The port of the JAX package's ``utils/serialize.py``, with its file layout
key for key, so each package reads the other's files.  The spec is the
expensive host artifact (the maxmin ordering and the neighbour search:
about a minute at n=1e6, m=40); the plan and the multifrontal structure
rebuild from it in seconds, so a spec written once serves every later
process, and every rank of a sharded run reads the one its first rank
wrote.

One difference: ``save_spec`` also writes ``zero_obs_mask`` (the
zero-nugget variant's mask of exact observations) under its own key when
the spec carries one, where the JAX package drops it.  The JAX
``load_spec`` reads only its own keys, so it ignores the extra one.
"""

from __future__ import annotations

import numpy as np

from ..spec import VecchiaSpec
from . import trace

__all__ = ["save_spec", "load_spec"]

_ARRAY_FIELDS = ("locsord", "NNarray", "cond_latent", "has_latent", "has_obs",
                 "ord", "ord_z", "known_pts")
_SCALAR_FIELDS = ("ordering_pred", "cond_yz", "conditioning", "ic0", "n_obs",
                  "n_pred", "mra_eff_m")
_EXTRA_FIELDS = ("zero_obs_mask",)


def save_spec(spec: VecchiaSpec, path) -> None:
    """Write a VecchiaSpec to ``path`` (.npz)."""
    data = {}
    for f in _ARRAY_FIELDS + _EXTRA_FIELDS:
        v = getattr(spec, f)
        if v is not None:
            data[f] = np.asarray(v)
    for f in _SCALAR_FIELDS:
        v = getattr(spec, f)
        data["meta_" + f] = np.asarray("" if v is None else v)
    np.savez_compressed(path, **data)


@trace.span("spec.load")
def load_spec(path) -> VecchiaSpec:
    """Load a VecchiaSpec written by ``save_spec`` (this package's or the
    JAX package's)."""
    with np.load(path, allow_pickle=False) as z:
        kw = {f: z[f] if f in z.files else None
              for f in _ARRAY_FIELDS + _EXTRA_FIELDS}
        for f in _SCALAR_FIELDS:
            s = str(z["meta_" + f][()])
            if f == "ic0":
                kw[f] = s in ("True", "true", "1")
            elif f in ("n_obs", "n_pred"):
                kw[f] = int(s)
            elif f == "mra_eff_m":
                kw[f] = None if s in ("", "None") else int(s)
            else:
                kw[f] = s
    return VecchiaSpec(**kw)
