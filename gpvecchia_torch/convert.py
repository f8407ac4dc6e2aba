"""State carried across from the JAX package: specs.

In this system the parameter-free ``VecchiaSpec`` plays the part that
weights play in a model; covariance parameters and nuggets cross as plain
numpy arrays.  Nothing here imports the JAX package: ``from_jax_spec``
duck-types the spec's numpy attributes, and ``load_spec``
(``utils/serialize.py``) reads the ``.npz`` layout that both packages'
``save_spec`` write.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .spec import VecchiaSpec
from .utils.serialize import load_spec

__all__ = ["from_jax_spec", "load_spec"]


def from_jax_spec(spec) -> VecchiaSpec:
    """A ``gpvecchia_tpu`` ``VecchiaSpec`` as the port's (arrays copied)."""
    kw = {}
    for f in dataclasses.fields(VecchiaSpec):
        if f.name.startswith("_"):
            continue
        v = getattr(spec, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return VecchiaSpec(**kw)
