"""Spec serialization: the port's ``utils/serialize.py`` vs the JAX
package's, on the CPU.

The port's ``save_spec`` writes the JAX package's layout key for key, so
the JAX ``load_spec`` reads it back (every array and scalar equal, and the
JAX likelihood of the loaded spec equal to that of the original); the
port's ``load_spec`` also restores ``zero_obs_mask``, which the JAX
package's ``save_spec`` drops (a reference fault the port does not copy).
"""

import dataclasses
import warnings

import numpy as np
import pytest

from gpvecchia_tpu.inference.likelihood import loglik_fn as jax_loglik_fn
from gpvecchia_tpu.utils import serialize as JS

import gpvecchia_torch as GT
from gpvecchia_torch.inference.likelihood import zero_nugget_variant
from gpvecchia_torch.utils import serialize as TS

from test_torch_prediction import jax_spec

N = 60
COVPARMS = np.array([1.0, 0.3, 0.5])
NUG = 0.2
CASES = ("sgv", "pred", "mra", "zero_nugget")


def make_case(case):
    """(the port's spec, z, nuggets) of ``case``: an SGV spec, one with
    prediction points (the default conditioning, zy), an MRA spec, and the
    zero-nugget variant of the SGV spec (every 7th observation exact),
    which carries ``zero_obs_mask``."""
    rng = np.random.default_rng(12)
    locs = rng.uniform(size=(N, 2))
    z = rng.normal(size=N)
    nug = np.full(N, NUG)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "pred":
            spec = GT.vecchia_specify(locs, m=6,
                                      locs_pred=rng.uniform(size=(10, 2)))
        elif case == "mra":
            spec = GT.vecchia_specify(locs, m=6, conditioning="mra")
        else:
            spec = GT.vecchia_specify(locs, m=6, cond_yz="SGV")
    if case == "zero_nugget":
        nug[::7] = 0.0
        spec = zero_nugget_variant(spec, nug)
        assert spec.zero_obs_mask is not None
    return spec, z, nug


def _fields(spec_cls):
    return [f.name for f in dataclasses.fields(spec_cls)
            if not f.name.startswith("_")]


def _assert_field_equal(name, a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a is not None and b is not None, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, name


@pytest.mark.parametrize("case", CASES)
def test_save_spec_reads_back_in_both_packages(tmp_path, case):
    spec, z, nug = make_case(case)
    path = tmp_path / "spec.npz"
    TS.save_spec(spec, path)

    # the JAX package's load_spec: every array and scalar of its layout
    sj = JS.load_spec(path)
    for f in JS._ARRAY_FIELDS + JS._SCALAR_FIELDS:
        _assert_field_equal(f, getattr(sj, f), getattr(spec, f))
    want = float(jax_loglik_fn(jax_spec(spec), "matern")(z, COVPARMS, nug))
    got = float(jax_loglik_fn(sj, "matern")(z, COVPARMS, nug))
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-14)

    # the port's load_spec: every field, zero_obs_mask included
    st = TS.load_spec(path)
    assert isinstance(st, GT.VecchiaSpec)
    for f in _fields(GT.VecchiaSpec):
        _assert_field_equal(f, getattr(st, f), getattr(spec, f))


def test_convert_load_spec_is_the_serializer():
    from gpvecchia_torch.convert import load_spec
    assert load_spec is TS.load_spec
