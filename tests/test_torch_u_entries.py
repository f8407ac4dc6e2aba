"""U entries and H1 (matern_solve_e0) vs the JAX package on the CPU.

The port's covariance closed forms and ``u_entries`` (whose CPU path is
H1's plain version) are held against ``gpvecchia_tpu`` in float64; H1's
plain version is also held against the Pallas kernel it replaces,
``pallas_crout.fused_matern_solve``, run in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpvecchia_tpu.kernels.pallas_crout as pc
from gpvecchia_tpu.kernels.covariance import matern as jax_matern
from gpvecchia_tpu.kernels.u_entries import u_entries as jax_u_entries

from gpvecchia_torch import vecchia_specify
from gpvecchia_torch.csrc.cuda import KernelCall
from gpvecchia_torch.kernels.covariance import matern
from gpvecchia_torch.kernels.matern_solve import (matern_solve_e0,
                                                  matern_solve_e0_plain,
                                                  max_neighbors)
from gpvecchia_torch.kernels.u_entries import u_entries
from gpvecchia_torch.plan import get_plan

torch.set_default_dtype(torch.float64)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_closed_forms_match_jax(nu):
    dist = np.random.default_rng(3).uniform(0.0, 2.0, size=500)
    dist[:7] = 0.0
    cp = np.array([1.3, 0.25, nu])
    ours = matern(torch.as_tensor(dist), torch.as_tensor(cp)).numpy()
    ref = np.asarray(jax_matern(jnp.asarray(dist), jnp.asarray(cp)))
    np.testing.assert_allclose(ours, ref, rtol=1e-13, atol=0)


def _spec_inputs(n=400, m=12, seed=11):
    locs = np.random.default_rng(seed).uniform(size=(n, 2))
    plan = get_plan(vecchia_specify(locs, m=m, cond_yz="SGV"))
    nug_point = np.full(plan.n_all, 0.15)
    return plan, nug_point


@pytest.mark.parametrize("poison", [False, True])
def test_u_entries_matches_jax(poison):
    plan, nug_point = _spec_inputs()
    if poison:
        # a hugely negative nugget on one response-conditioned neighbor makes
        # every conditioning matrix that holds it non-SPD
        q = plan.NN[plan.nb_resp][0]
        nug_point[q] = -1e3
    cp = np.array([1.0, 0.2, 0.5])
    col, bad = u_entries(torch.as_tensor(plan.locs),
                         torch.as_tensor(plan.NN), torch.as_tensor(plan.valid),
                         torch.as_tensor(plan.cond),
                         torch.as_tensor(nug_point), cp)
    colj, badj = jax_u_entries(jnp.asarray(plan.locs), jnp.asarray(plan.NN),
                               jnp.asarray(plan.valid),
                               jnp.asarray(plan.cond), jnp.asarray(nug_point),
                               jax_matern, jnp.asarray(cp))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(badj))
    assert bad.any() == poison
    colj = np.asarray(colj)
    np.testing.assert_allclose(col.numpy(), colj, rtol=0,
                               atol=1e-12 * np.abs(colj).max())


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_h1_plain_matches_pallas_interpret(interpret, nu):
    """f32, n=300, F=9: both sides are float32 factorizations of the same
    SPD matrices in other orders; allow 1e-4 of the largest entry.  The
    short range (0.05, about the point spacing) keeps the smooth kernels'
    conditioning matrices well conditioned enough for float32."""
    plan, nug_point = _spec_inputs(n=300, m=8, seed=5)
    F, d = plan.NN.shape[1], plan.locs.shape[1]
    cp = np.array([1.0, 0.05, nu], np.float32)
    resp = plan.valid & ~plan.cond
    x = matern_solve_e0_plain(
        torch.as_tensor(plan.locs, dtype=torch.float32),
        torch.as_tensor(plan.NN), torch.as_tensor(plan.valid),
        torch.as_tensor(resp), torch.as_tensor(nug_point, dtype=torch.float32),
        torch.as_tensor(cp)).numpy()
    pts = plan.locs[plan.NN].astype(np.float32)            # (n, F, d)
    geoT = np.transpose(pts, (2, 1, 0)).reshape(d * F, -1)
    nugT = np.where(resp, nug_point[plan.NN], 0.0).T.astype(np.float32)
    validT = plan.valid.T.astype(np.float32)
    xj = pc.fused_matern_solve(jnp.asarray(cp), jnp.asarray(nugT),
                               jnp.asarray(geoT), jnp.asarray(validT),
                               jnp.asarray(pts.reshape(len(pts), -1)),
                               F, d, False)
    xj = np.asarray(xj).T
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-4 * np.abs(xj).max())


def test_h1_wrapper_takes_plain_version_on_cpu():
    plan, nug_point = _spec_inputs(n=200, m=6)
    args = (torch.as_tensor(plan.locs), torch.as_tensor(plan.NN),
            torch.as_tensor(plan.valid),
            torch.as_tensor(plan.valid & ~plan.cond),
            torch.as_tensor(nug_point))
    before = matern_solve_e0.launches
    x = matern_solve_e0(*args, (1.0, 0.2, 0.5))
    assert matern_solve_e0.launches == before       # no kernel on the CPU
    torch.testing.assert_close(
        x, matern_solve_e0_plain(*args, torch.tensor([1.0, 0.2, 0.5])),
        rtol=0, atol=0)


def test_h1_shared_memory_bound():
    # m=40 at d=2 fits a warp's 48 KB in both precisions
    assert max_neighbors(2, torch.float64) >= 41
    assert max_neighbors(2, torch.float32) > max_neighbors(2, torch.float64)


def test_kernel_backward_raises():
    """Gradients through a CUDA kernel must fail loudly, not silently drop
    the kernel's part of the graph."""
    x = torch.ones(3, requires_grad=True)
    y = KernelCall.apply("fake", lambda t: t * 2.0, -1, x)
    with pytest.raises(NotImplementedError, match="fake"):
        y.sum().backward()
