"""State carried across from the JAX package: specs.

In this system the parameter-free ``VecchiaSpec`` plays the part that
weights play in a model; covariance parameters and nuggets cross as plain
numpy arrays.  Nothing here imports the JAX package: ``from_jax_spec``
duck-types the spec's numpy attributes and ``load_spec`` reads the ``.npz``
layout written by ``gpvecchia_tpu.utils.serialize.save_spec``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .spec import VecchiaSpec

__all__ = ["from_jax_spec", "load_spec"]

_ARRAY_FIELDS = ("locsord", "NNarray", "cond_latent", "has_latent", "has_obs",
                 "ord", "ord_z", "known_pts")
_SCALAR_FIELDS = ("ordering_pred", "cond_yz", "conditioning", "ic0", "n_obs",
                  "n_pred", "mra_eff_m")


def from_jax_spec(spec) -> VecchiaSpec:
    """A ``gpvecchia_tpu`` ``VecchiaSpec`` as the port's (arrays copied)."""
    kw = {}
    for f in dataclasses.fields(VecchiaSpec):
        if f.name.startswith("_"):
            continue
        v = getattr(spec, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return VecchiaSpec(**kw)


def load_spec(path) -> VecchiaSpec:
    """Load a spec written by the JAX package's ``save_spec`` (.npz)."""
    with np.load(path, allow_pickle=False) as z:
        kw = {}
        for f in _ARRAY_FIELDS:
            kw[f] = z[f] if f in z.files else None
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
