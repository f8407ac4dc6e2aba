"""The port's host path (spec, plan, MF plan, spec loading) vs the JAX package.

The host code is NumPy + C++ and deterministic, so the port's arrays must
equal the JAX package's exactly.  Also checks that the port imports neither
jax nor gpvecchia_tpu, and that its host build writes only under its own
build directory.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gpvecchia_tpu as GJ
from gpvecchia_tpu.plan import get_mf_plan as jax_get_mf_plan
from gpvecchia_tpu.plan import get_plan as jax_get_plan
from gpvecchia_tpu.utils.serialize import save_spec

import gpvecchia_torch as GT
from gpvecchia_torch.convert import from_jax_spec, load_spec
from gpvecchia_torch.csrc import host
from gpvecchia_torch.plan import get_mf_plan, get_plan

torch.set_default_dtype(torch.float64)

REPO = Path(__file__).resolve().parents[1]
SPEC_ARRAYS = ("locsord", "NNarray", "cond_latent", "has_latent", "has_obs",
               "ord", "ord_z")


def _locs(n, seed=1988):
    return np.random.default_rng(seed).uniform(size=(n, 2))


def _assert_spec_equal(a, b):
    for f in SPEC_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for f in ("ordering_pred", "cond_yz", "conditioning", "ic0", "n_obs",
              "n_pred"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("n,m", [(60, 5), (2000, 20)])
@pytest.mark.parametrize("cond", ["y", "z", "SGV", "SGVT"])
def test_specify_matches_jax(n, m, cond):
    locs = _locs(n)
    _assert_spec_equal(GT.vecchia_specify(locs, m=m, cond_yz=cond),
                       GJ.vecchia_specify(locs, m=m, cond_yz=cond))


def test_specify_m0_matches_jax():
    locs = _locs(60)
    _assert_spec_equal(GT.vecchia_specify(locs, m=0),
                       GJ.vecchia_specify(locs, m=0))


@pytest.mark.parametrize("n,depth0", [(60, True), (2000, False)])
def test_plans_match_jax(n, depth0):
    locs = _locs(n, seed=7)
    spec_t = GT.vecchia_specify(locs, m=20 if n > 60 else 8)
    spec_j = GJ.vecchia_specify(locs, m=20 if n > 60 else 8)
    pt, pj = get_plan(spec_t), jax_get_plan(spec_j, np.float64)
    assert pt.mode == pj.mode and pt.use_mf and pj.use_mf
    for f in ("NN", "valid", "cond", "has_latent_pts", "latent_rank",
              "obs_pos", "obs_points", "ord_z", "nb_obs_pos", "nb_resp",
              "known_pts", "zero_obs"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f),
                                      err_msg=f)
    (mt, vt), (mj, vj) = get_mf_plan(pt), jax_get_mf_plan(pj)
    np.testing.assert_array_equal(vt, vj)
    assert mt.depth == mj.depth and (mt.depth == 0) == depth0
    np.testing.assert_array_equal(mt.x_slot, mj.x_slot)
    for lt, lj in zip(mt.levels, mj.levels):
        assert (lt.npiv, lt.nbord) == (lj.npiv, lj.nbord)
        for f in ("piv_ids", "ext", "bord_in_parent", "bord_x_slot",
                  "elem_pt", "elem_pos"):
            a, b = getattr(lt, f), getattr(lj, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_load_spec_roundtrips_save_spec(tmp_path):
    spec_j = GJ.vecchia_specify(_locs(300), m=10, cond_yz="SGVT")
    path = tmp_path / "spec.npz"
    save_spec(spec_j, path)
    _assert_spec_equal(load_spec(path), spec_j)


def test_from_jax_spec_copies_arrays():
    spec_j = GJ.vecchia_specify(_locs(300), m=10)
    spec_t = from_jax_spec(spec_j)
    _assert_spec_equal(spec_t, spec_j)
    assert isinstance(spec_t, GT.VecchiaSpec)
    assert spec_t.NNarray is not spec_j.NNarray


def test_mra_conditioning_not_ported():
    with pytest.raises(NotImplementedError):
        GT.vecchia_specify(_locs(60), m=5, conditioning="firstm")


def test_port_imports_neither_jax_nor_reference():
    modules = []
    for p in sorted((REPO / "gpvecchia_torch").rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        modules.append(".".join(parts[:-1] if parts[-1] == "__init__"
                                else parts))
    code = (
        "import sys, importlib\n"
        "pre = 'jax' in sys.modules\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "assert 'gpvecchia_tpu' not in sys.modules\n"
        "assert pre or 'jax' not in sys.modules, 'jax imported'\n"
        "from gpvecchia_torch.csrc import cuda, host\n"
        "assert not host._tried and cuda._lib is None, 'import built'\n"
        "print(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 15


def test_host_library_builds_only_in_port_build_dir():
    assert host.native_loaded()
    path = host.library_path()
    assert path.exists()
    assert path.parent == host.BUILD_DIR
    assert (REPO / "gpvecchia_torch") in path.parents
    assert (REPO / "gpvecchia_tpu") not in path.parents
    assert host.SOURCE == REPO / "gpvecchia_torch" / "csrc" / "hostops.cpp"


def test_host_source_is_a_copy_of_the_reference():
    """The port compiles its own copy of the host C++; it must stay
    byte-identical to the JAX package's, so drift fails here."""
    ours = (REPO / "gpvecchia_torch" / "csrc" / "hostops.cpp").read_bytes()
    ref = (REPO / "gpvecchia_tpu" / "csrc" / "hostops.cpp").read_bytes()
    assert ours == ref
