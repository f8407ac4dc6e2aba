"""H8 ``solve_e0`` (K3's counterpart) and its backward ``solve_e0_bwd`` (K2)
through their plain versions vs the Pallas kernels in interpret mode.

The JAX package's layout is (P, n) lane-batched; the port's is (n, P)
point-major with the same packed order (the upper triangle row by row), so
the comparisons transpose.  Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpvecchia_tpu.kernels.pallas_crout as pc

from gpvecchia_torch.kernels import matern_solve as MS
from gpvecchia_torch.utils import trace

torch.set_default_dtype(torch.float64)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)
    pc._make_solver.cache_clear()
    yield
    pc._make_solver.cache_clear()


def _packed_spd(rng, n, F, dtype=np.float32):
    A = rng.normal(size=(n, F, F))
    C = A @ np.swapaxes(A, 1, 2) + F * np.eye(F)
    iu, ju = np.triu_indices(F)
    return C, C[:, iu, ju].astype(dtype)


@pytest.mark.parametrize("F", [3, 9, 21])
def test_solve_e0_plain_matches_pallas_k3(interpret, F):
    """f32, n=300: both sides factor the same SPD matrices in float32 in
    other orders; 1e-5 of the largest entry (F*I keeps cond small)."""
    C, Cp = _packed_spd(np.random.default_rng(F), 300, F)
    x = MS.solve_e0_plain(torch.as_tensor(Cp)).numpy()
    xj = np.asarray(pc._solve_e0_impl(jnp.asarray(Cp.T), F)).T
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-5 * np.abs(xj).max())
    xref = np.linalg.solve(C, np.eye(F)[0])
    np.testing.assert_allclose(x, xref, rtol=0,
                               atol=1e-5 * np.abs(xref).max())


@pytest.mark.parametrize("F", [3, 9, 21])
def test_packed_solve_e0_backward_matches_pallas_vjp(interpret, F):
    """The backward of ``packed_solve_e0`` (K2's packed cotangent) vs
    ``jax.vjp`` of the Pallas ``packed_solve_e0`` (K3 forward, K2
    backward), f32, 1e-4 of the largest entry."""
    rng = np.random.default_rng(10 + F)
    _, Cp = _packed_spd(rng, 200, F)
    xbar = rng.normal(size=(200, F)).astype(np.float32)
    cp = torch.tensor(Cp, requires_grad=True)
    x = MS.packed_solve_e0(cp)
    x.backward(torch.as_tensor(xbar))
    xj, vjp = jax.vjp(lambda c: pc.packed_solve_e0(c, F), jnp.asarray(Cp.T))
    (gj,) = vjp(jnp.asarray(xbar.T))
    gj = np.asarray(gj).T
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(xj).T, rtol=0,
                               atol=1e-5 * np.abs(np.asarray(xj)).max())
    np.testing.assert_allclose(cp.grad.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())


def test_packed_solve_e0_gradcheck():
    _, Cp = _packed_spd(np.random.default_rng(2), 6, 5, np.float64)
    cp = torch.tensor(Cp, requires_grad=True)
    assert torch.autograd.gradcheck(MS.packed_solve_e0, (cp,))


def test_non_spd_row_is_nan_in_its_own_row():
    C, Cp = _packed_spd(np.random.default_rng(5), 50, 7, np.float64)
    Cp[17, 0] = -1.0                       # a negative first pivot
    x = MS.solve_e0(torch.as_tensor(Cp)).numpy()
    assert np.isnan(x[17]).all()
    ok = np.arange(50) != 17
    np.testing.assert_allclose(x[ok], np.linalg.solve(C[ok], np.eye(7)[0]),
                               rtol=1e-12)


def test_wrapper_takes_plain_version_on_cpu():
    _, Cp = _packed_spd(np.random.default_rng(6), 40, 6, np.float64)
    before = trace.table().get("launches.solve_e0")
    x = MS.solve_e0(torch.as_tensor(Cp))
    assert trace.table().get("launches.solve_e0") == before  # no kernel
    torch.testing.assert_close(x, MS.solve_e0_plain(torch.as_tensor(Cp)),
                               rtol=0, atol=0)


def test_wrapper_raises_on_other_devices_and_bad_shapes():
    with pytest.raises(ValueError, match="unsupported device"):
        MS.solve_e0(torch.empty(4, 10, device="meta"))
    with pytest.raises(ValueError, match="packed triangle"):
        MS.solve_e0(torch.zeros(4, 11))
    with pytest.raises(TypeError):
        MS.solve_e0(torch.zeros(4, 10, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_e0_shares_the_backward_bound(dtype):
    """H8 refuses, before any launch, the F that its backward refuses."""
    F = MS._max_f(0, dtype, MS._FWD_VECS) + 1
    Cp = torch.zeros(1, F * (F + 1) // 2, dtype=dtype)
    with pytest.raises(ValueError, match=f"F <= {F - 1} for d=0"):
        MS._launch_solve(Cp, F)
