"""H2/H3/H4 plain versions vs the Pallas kernels they replace, and the
port's multifrontal factor vs the JAX ``mf_factor``, on the CPU.

The Pallas kernels run in interpret mode; the comparisons are float32 with
the existing kernel tests' atol 2e-4 (tests/test_pallas_level.py).  The
TPU-side panel plans are built inside the tests, as that file does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpvecchia_tpu.linalg.pallas_eadd as pe
import gpvecchia_tpu.linalg.pallas_frontal as pf
from gpvecchia_tpu.linalg import pallas_level as PL
from gpvecchia_tpu.linalg.multifrontal import mf_device_arrays as jax_mfdev
from gpvecchia_tpu.linalg.multifrontal import mf_factor as jax_mf_factor

from gpvecchia_torch import vecchia_specify
from gpvecchia_torch.linalg.frontal import (extend_add, extend_add_plain,
                                            front_factor_plain,
                                            leaf_assemble_plain)
from gpvecchia_torch.linalg.multifrontal import mf_device_arrays, mf_factor
from gpvecchia_torch.plan import get_mf_plan, get_plan

torch.set_default_dtype(torch.float64)

ATOL = 2e-4


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(PL, "INTERPRET", True)
    monkeypatch.setattr(PL, "_MAX_GB", 2)
    monkeypatch.setattr(pe, "INTERPRET", True)
    monkeypatch.setattr(pf, "INTERPRET", True)
    PL._make_fused.cache_clear()
    PL._make_leaf.cache_clear()
    PL._make_afront.cache_clear()
    yield
    PL._make_fused.cache_clear()
    PL._make_leaf.cache_clear()
    PL._make_afront.cache_clear()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _factored_parts(front, P):
    f = front.numpy()
    return np.tril(f[:, :P, :P]), f[:, P:, :P], f[:, P:, P:]


def _level_inputs(seed=0, N=4, P=13, B=9, Bc=17):
    """Children updates, a monotone ext map with the augmented entry, and
    diag/rhs vectors (as tests/test_pallas_level.py builds them)."""
    rng = np.random.default_rng(seed)
    B1, Bc1 = B + 1, Bc + 1
    F1 = P + B1
    ch = rng.normal(size=(N, 2, Bc1, Bc1)).astype(np.float32)
    ch = ch + np.swapaxes(ch, 2, 3)
    ext = np.full((N, 2, F1), -1, np.int32)
    for n in range(N):
        for s in (0, 1):
            pos = np.sort(rng.choice(F1 - 1, size=Bc1 - 1, replace=False))
            ext[n, s, pos] = np.arange(Bc1 - 1)
            ext[n, s, F1 - 1] = Bc1 - 1
    diag = rng.uniform(1.0, 2.0, size=(N, F1)).astype(np.float32) + 4.0 * F1
    diag[:, F1 - 1] = 0.0
    rhs = rng.normal(size=(N, F1)).astype(np.float32)
    rhs[:, F1 - 1] = 0.0
    return ch, ext, diag, rhs, P, B1, Bc1, F1


def _pallas_level_args(ch, ext, diag, rhs, Bc1, F1):
    N = ch.shape[0]
    Bc1p = PL._ru(max(Bc1, PL._srows(Bc1)), 8)
    chp = np.zeros((N, 2, Bc1p, Bc1), np.float32)
    chp[:, :, :Bc1] = ch
    starts, rel, T, F1p = PL.level_kernel_plan(ext, Bc1)
    diag2 = np.zeros((N, 8, F1p), np.float32)
    diag2[:, 0, :F1] = diag
    diag2[:, 1, :F1] = rhs
    diagT = np.zeros((N, F1p, 8), np.float32)
    diagT[:, :F1, 0] = diag
    diagT[:, :F1, 1] = rhs
    return chp, starts, rel, T, diag2, diagT


def test_h3_h4_match_fused_level(interpret):
    ch, ext, diag, rhs, P, B1, Bc1, F1 = _level_inputs()
    chp, starts, rel, T, diag2, _ = _pallas_level_args(ch, ext, diag, rhs,
                                                       Bc1, F1)
    L_pp, L_bp, upd = PL.fused_level(jnp.asarray(chp), jnp.asarray(starts),
                                     jnp.asarray(rel), jnp.asarray(diag2),
                                     P, B1, Bc1, F1, T)
    front = extend_add_plain(_t(ch), _t(ext), _t(diag), _t(rhs))
    lpp, lbp, updp = _factored_parts(front_factor_plain(front, P), P)
    np.testing.assert_allclose(lpp, np.asarray(L_pp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lbp, np.asarray(L_bp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(updp, np.asarray(upd)[:, :B1], rtol=0,
                               atol=ATOL)


def test_h3_matches_assemble_fronts(interpret):
    ch, ext, diag, rhs, P, B1, Bc1, F1 = _level_inputs(seed=13, N=2, P=20,
                                                       B=30, Bc=40)
    chp, starts, rel, T, diag2, diagT = _pallas_level_args(ch, ext, diag, rhs,
                                                           Bc1, F1)
    ref = PL.assemble_fronts(jnp.asarray(chp), jnp.asarray(starts),
                             jnp.asarray(rel), jnp.asarray(diag2),
                             jnp.asarray(diagT), Bc1, F1, T)
    front = extend_add_plain(_t(ch), _t(ext), _t(diag), _t(rhs))
    np.testing.assert_allclose(front.numpy(), np.asarray(ref)[:, :F1, :F1],
                               rtol=0, atol=ATOL)


def test_h3_matches_eadd_fronts(interpret):
    rng = np.random.default_rng(4)
    N, F, Bc = 4, 30, 17
    upd2 = rng.normal(size=(N, 2, Bc, Bc)).astype(np.float32)
    ext = np.full((N, 2, F), -1, np.int32)
    for n in range(N):
        for s in range(2):
            k = int(rng.integers(5, Bc))
            pos = rng.choice(F, size=k, replace=False)
            ext[n, s, pos] = rng.choice(Bc, size=k, replace=False)
    ref = pe.eadd_fronts(jnp.asarray(upd2), jnp.asarray(ext), F)
    zero = torch.zeros(N, F, dtype=torch.float32)
    front = extend_add_plain(_t(upd2), _t(ext), zero, zero)
    np.testing.assert_allclose(front.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_h3_reads_strided_child_fronts():
    """The children's Schur blocks are read in place from their fronts."""
    ch, ext, diag, rhs, P, B1, Bc1, F1 = _level_inputs(seed=2, N=3)
    Pc = 5
    child = torch.zeros(6, Pc + Bc1, Pc + Bc1, dtype=torch.float32)
    child[:, Pc:, Pc:] = _t(ch).reshape(6, Bc1, Bc1)
    view = child[:, Pc:, Pc:].unflatten(0, (3, 2))
    assert not view.is_contiguous()
    torch.testing.assert_close(extend_add(view, _t(ext), _t(diag), _t(rhs)),
                               extend_add_plain(_t(ch), _t(ext), _t(diag),
                                                _t(rhs)), rtol=0, atol=0)


@pytest.mark.parametrize("F,P", [(12, 5), (50, 50), (37, 16)])
def test_h4_matches_factor_fronts(interpret, F, P):
    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, F, F)).astype(np.float32) * 0.1
    front = (A @ np.swapaxes(A, 1, 2)
             + np.eye(F, dtype=np.float32) * 3).astype(np.float32)
    L_pp, L_bp = pf.factor_fronts(jnp.asarray(front), P)
    lpp, lbp, upd = _factored_parts(front_factor_plain(_t(front).clone(), P),
                                    P)
    np.testing.assert_allclose(lpp, np.asarray(L_pp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lbp, np.asarray(L_bp), rtol=0, atol=ATOL)
    Lbp = np.asarray(L_bp, np.float64)
    np.testing.assert_allclose(
        upd, front[:, P:, P:] - Lbp @ np.swapaxes(Lbp, 1, 2), rtol=0,
        atol=ATOL)


def test_h2_h4_match_fused_leaf(interpret):
    rng = np.random.default_rng(1)
    N, P, B, EL, K = 2, 11, 7, 15, 5
    B1 = B + 1
    F1 = P + B1
    ELp = PL._ru(EL, 8)
    u = np.zeros((N, ELp, K), np.float32)
    epos = np.full((N, ELp, K), -1, np.int32)
    re = np.zeros((N, ELp), np.float32)
    for n in range(N):
        for e in range(EL):
            k = rng.integers(1, K + 1)
            epos[n, e, :k] = np.sort(rng.choice(F1 - 1, size=k, replace=False))
            u[n, e, :k] = rng.normal(size=k)
            re[n, e] = rng.normal()
    diag = rng.uniform(1.0, 2.0, size=(N, F1)).astype(np.float32) + 2.0 * F1
    diag[:, F1 - 1] = 0.0
    rhs = rng.normal(size=(N, F1)).astype(np.float32)
    rhs[:, F1 - 1] = 0.0
    # the fused kernel's transposed (N, K+1, ELp) layout, RHS weight last
    u_aug = np.concatenate([u, re[..., None]], axis=2)
    epos_aug = np.concatenate(
        [epos, np.where(np.arange(ELp) < EL, F1 - 1, -1)[None, :, None]
         .repeat(N, 0).astype(np.int32)], axis=2)
    F1p = PL._ru(F1, PL._TE)
    diag2 = np.zeros((N, 8, F1p), np.float32)
    diag2[:, 0, :F1] = diag
    diag2[:, 1, :F1] = rhs
    L_pp, L_bp, upd = PL.fused_leaf(jnp.asarray(np.swapaxes(u_aug, 1, 2)),
                                    jnp.asarray(np.swapaxes(epos_aug, 1, 2)),
                                    jnp.asarray(diag2), P, B1, F1)
    front = leaf_assemble_plain(_t(u), _t(epos), _t(re), _t(diag), _t(rhs))
    lpp, lbp, updp = _factored_parts(front_factor_plain(front, P), P)
    np.testing.assert_allclose(lpp, np.asarray(L_pp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lbp, np.asarray(L_bp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(updp, np.asarray(upd)[:, :B1], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n,m", [(60, 8), (2000, 20)])
def test_mf_factor_matches_jax(n, m):
    """logdet and quad of the port's augmented chain vs the JAX mf_factor on
    a real plan (n=60 is a depth-0 plan: the single leaf is the root)."""
    rng = np.random.default_rng(n)
    plan = get_plan(vecchia_specify(rng.uniform(size=(n, 2)), m=m))
    mf, _ = get_mf_plan(plan)
    assert (mf.depth == 0) == (n == 60)
    lr = plan.latent_rank.astype(np.int64)
    elem_verts = np.where(plan.cond, lr[plan.NN], -1)
    u = np.where(elem_verts >= 0, rng.normal(size=elem_verts.shape), 0.0)
    u[:, 0] = np.abs(u[:, 0]) + 1.0
    dvec = rng.uniform(1.0, 3.0, size=plan.n_lat)
    rhs_elem = rng.normal(size=elem_verts.shape[0])
    rhs_vert = rng.normal(size=plan.n_lat)
    logdet, quad = mf_factor(mf_device_arrays(mf, "cpu"), _t(u), _t(dvec),
                             _t(rhs_elem), _t(rhs_vert))
    static, arrays = jax_mfdev(mf, fused=False)
    ref = jax_mf_factor(static, arrays, jnp.asarray(u), jnp.asarray(dvec),
                        rhs_elem=jnp.asarray(rhs_elem),
                        rhs_vert=jnp.asarray(rhs_vert), dtype=jnp.float64)
    np.testing.assert_allclose(float(logdet), float(ref["logdet"]),
                               rtol=1e-11)
    np.testing.assert_allclose(float(quad), float(ref["quad"]), rtol=1e-11)
