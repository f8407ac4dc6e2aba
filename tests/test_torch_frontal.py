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
from gpvecchia_torch.linalg.frontal import (H2_EDGE_SHAPES, H3_EDGE_SHAPES,
                                            H4_EDGE_SHAPES, extend_add,
                                            extend_add_plain, front_factor,
                                            front_factor_plain,
                                            h2_edge_inputs, h3_edge_inputs,
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


# beside the first three cases, edge shapes of H4's blocked schedule that
# ``factor_fronts`` takes in interpret mode: P = 32 with no border but the
# RHS row, P one past an inner panel, P = F - 1, and a front one past a tile
@pytest.mark.parametrize("F,P", [(12, 5), (50, 50), (37, 16), (33, 32),
                                 (70, 33), (40, 39), (130, 64)])
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


def _spd_fronts(N, F1, seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(N, F1, F1)) / np.sqrt(F1)
    return _t(G @ np.swapaxes(G, 1, 2) + np.eye(F1))


def test_h4_edge_shapes_cover_the_schedule():
    """The list the card check runs holds the edges of the blocked schedule
    (inner panels of 32, outer panels of 128, tiles of 64 and 128)."""
    shapes = set(H4_EDGE_SHAPES)
    P_of = {P for _, _, P in shapes}
    assert {31, 32, 33} & P_of and min(P_of) < 32
    for W in (128, 256):
        assert {W - 1, W, W + 1} <= P_of
    assert any(P == F1 - 1 for _, F1, P in shapes)          # no border
    assert any(F1 - P == 2 for _, F1, P in shapes)          # B1 = 2
    assert {129, 257} <= {F1 for _, F1, _ in shapes}
    assert any(N == 1 for N, _, _ in shapes)
    assert all(0 < P < F1 for _, F1, P in shapes)


@pytest.mark.parametrize("N,F1,P", [s for s in H4_EDGE_SHAPES if s[1] <= 300])
def test_h4_plain_at_edge_shapes(N, F1, P):
    """The plain version (the kernel's oracle on the card) is a partial
    Cholesky at every edge shape: its three blocks rebuild the front."""
    front = _spd_fronts(N, F1, F1 + P)
    lpp, lbp, upd = _factored_parts(front_factor_plain(front.clone(), P), P)
    ref = front.numpy()
    np.testing.assert_allclose(lpp @ np.swapaxes(lpp, 1, 2), ref[:, :P, :P],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(lbp @ np.swapaxes(lpp, 1, 2), ref[:, P:, :P],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(upd + lbp @ np.swapaxes(lbp, 1, 2),
                               ref[:, P:, P:], rtol=0, atol=1e-12)


def test_h4_plain_not_spd_front_is_nan_alone():
    """A front that is not SPD gives NaN there; its neighbours in the batch
    equal what they give alone."""
    N, F1, P = 3, 40, 25
    front = _spd_fronts(N, F1, 5)
    front[1, P // 2, P // 2] = -1.0
    out = front_factor_plain(front.clone(), P)
    assert torch.isnan(out[1, :P, :P]).all()
    assert torch.isnan(out[1, P:, :P]).all()
    assert torch.isnan(out[1, P:, P:]).all()
    for n in (0, 2):
        alone = front_factor_plain(front[n:n + 1].clone(), P)
        assert torch.isfinite(out[n]).all()
        torch.testing.assert_close(out[n], alone[0], rtol=0, atol=0)


@pytest.mark.parametrize("N,F1,P", [(2, 40, 7), (2, 70, 33), (2, 40, 39),
                                    (3, 130, 64)])
def test_h4_ignores_the_upper_triangle(N, F1, P):
    """NaN in the strict upper triangle of the input does not reach the
    lower-triangle outputs of ``front_factor`` (on the CPU: its plain
    version)."""
    front = _spd_fronts(N, F1, 9)
    clean = torch.tril(front_factor(front.clone(), P))
    up = torch.ones(F1, F1, dtype=torch.bool).triu(1)
    dirty = torch.tril(front_factor(front.masked_fill(up, torch.nan), P))
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


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


def test_h2_h3_edge_shapes_cover_the_kernels():
    """The lists the card check runs hold the edges of H2's bands and H3's
    64-tiles, and their inputs the element and child patterns named."""
    f1_h3 = {F1 for _, F1, _, _ in H3_EDGE_SHAPES}
    assert {1, 2, 63, 64, 65, 129, 257} <= f1_h3
    assert any(Bc1 == 1 for _, _, Bc1, _ in H3_EDGE_SHAPES)
    assert any(split and F1 > 128 for _, F1, _, split in H3_EDGE_SHAPES)
    upd, ext, _, _ = h3_edge_inputs(2, 257, 128, True, 0)
    assert (ext[:, 1, :64] < 0).all() and (ext[:, 0, 128:256] < 0).all()
    assert torch.equal(upd, upd.mT)
    assert all((np.diff(e[e >= 0].numpy()) > 0).all()
               for e in ext.reshape(-1, 257))
    f1_h2 = {F1 for _, F1, _, _ in H2_EDGE_SHAPES}
    assert {1, 2, 65, 129, 330} <= f1_h2
    assert any(EL == 1 for _, _, EL, _ in H2_EDGE_SHAPES)
    assert {31, 32, 64} <= {K for _, _, _, K in H2_EDGE_SHAPES}
    u, epos, re, _, _ = h2_edge_inputs(2, 330, 96, 41, 0)
    valid = (epos >= 0).sum(-1)
    assert (valid == 41).any() and (valid[:, :-19] == 0).any()
    assert (valid[:, -19:] == 0).all() and (re[:, -19:] == 0).all()
    assert ((u != 0) <= (epos >= 0)).all()
    assert any((np.diff(p[p >= 0].numpy()) < 0).any()
               for p in epos.reshape(-1, 41))


def _np(t, dt=np.float32):
    return t.numpy().astype(dt)


@pytest.mark.parametrize("shape", H3_EDGE_SHAPES)
def test_h3_plain_at_edge_shapes_matches_pallas(interpret, shape):
    """extend_add's plain version (the kernel's oracle on the card, which
    must equal it bit for bit) against eadd_fronts and assemble_fronts at
    H3's edge shapes."""
    N, F1, Bc1, _ = shape
    upd, ext, dv, rv = h3_edge_inputs(*shape, seed=F1 + Bc1)
    upd32 = _np(upd)
    ref = pe.eadd_fronts(jnp.asarray(upd32), jnp.asarray(ext.numpy()), F1)
    zero = torch.zeros(N, F1)
    np.testing.assert_allclose(
        extend_add_plain(_t(upd32), ext, zero, zero).numpy(), np.asarray(ref),
        rtol=0, atol=ATOL)
    chp, starts, rel, T, diag2, diagT = _pallas_level_args(
        upd32, ext.numpy(), _np(dv), _np(rv), Bc1, F1)
    ref = PL.assemble_fronts(jnp.asarray(chp), jnp.asarray(starts),
                             jnp.asarray(rel), jnp.asarray(diag2),
                             jnp.asarray(diagT), Bc1, F1, T)
    np.testing.assert_allclose(
        extend_add_plain(_t(upd32), ext, _t(_np(dv)), _t(_np(rv))).numpy(),
        np.asarray(ref)[:, :F1, :F1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [s for s in H2_EDGE_SHAPES if s[1] <= 330])
def test_h2_plain_at_edge_shapes_matches_pallas(interpret, shape):
    """leaf_assemble's plain version (the kernel's oracle on the card)
    against fused_leaf at H2's edge shapes, compared after the partial
    factor that fused_leaf applies (P = (F1 - 1) // 2).  fused_leaf needs a
    pivot, so F1 = 1 (the RHS row alone) is held against the dense sum."""
    N, F1, EL, K = shape
    u, epos, re, dv, rv = h2_edge_inputs(*shape, seed=F1 + EL)
    front = leaf_assemble_plain(u, epos, re, dv, rv)
    if F1 == 1:
        np.testing.assert_allclose(front[:, 0, 0].numpy(),
                                   (re ** 2).sum(1).numpy() + dv[:, 0].numpy(),
                                   rtol=1e-14)
        return
    P = max(1, (F1 - 1) // 2)
    B1 = F1 - P
    ELp = PL._ru(EL, 8)
    pad = ((0, 0), (0, ELp - EL))
    u_aug = np.concatenate([np.pad(_np(u), pad + ((0, 0),)),
                            np.pad(_np(re), pad)[..., None]], axis=2)
    epos_aug = np.concatenate(
        [np.pad(epos.numpy(), pad + ((0, 0),), constant_values=-1),
         np.where(np.arange(ELp) < EL, F1 - 1, -1)[None, :, None]
         .repeat(N, 0).astype(np.int32)], axis=2)
    diag2 = np.zeros((N, 8, PL._ru(F1, PL._TE)), np.float32)
    diag2[:, 0, :F1] = _np(dv)
    diag2[:, 1, :F1] = _np(rv)
    L_pp, L_bp, upd = PL.fused_leaf(jnp.asarray(np.swapaxes(u_aug, 1, 2)),
                                    jnp.asarray(np.swapaxes(epos_aug, 1, 2)),
                                    jnp.asarray(diag2), P, B1, F1)
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
