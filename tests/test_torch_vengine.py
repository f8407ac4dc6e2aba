"""The port's per-entry V engine vs the JAX package, on the CPU in float64.

The plans the multifrontal engine does not take: the zy family's 'direct'
mode (V is the reversed U columns), the 'obspred' mode of specs with
obspred prediction points (the observed block factored per entry), and
IC0 (the factor on the unfilled pattern).  Held against the JAX package:
the host's symbolic fill and levels, the plan's V arrays and schedules
(array for array), ``pair_sum``, the solves and the selected inverse; the
log-likelihood and its gradient (and ``reference_impl``'s dense
likelihood); and the host IC0 functions ``ic0_csr``, ``create_L`` and
``ichol`` (bit for bit).  The posterior on these plans is
``test_torch_vpred.py``'s.  Inputs are made with numpy from a seed.
"""

import ast
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

import gpvecchia_tpu as GJ
from gpvecchia_tpu import hv as JH
from gpvecchia_tpu import plan as JP
from gpvecchia_tpu.linalg import selinv as JS
from gpvecchia_tpu.linalg import sparse as JSP
from gpvecchia_tpu.linalg import trisolve as JT
from gpvecchia_tpu.linalg.ichol import ichol as jax_ichol

import gpvecchia_torch as GT
from gpvecchia_torch import hv as TH
from gpvecchia_torch import plan as TP
from gpvecchia_torch.linalg import selinv as TS
from gpvecchia_torch.linalg import sparse as TSP
from gpvecchia_torch.linalg import trisolve as TT
from gpvecchia_torch.linalg.ichol import ichol

from reference_impl import dense_loglik, matern_np
from test_torch_prediction import jax_spec

torch.set_default_dtype(torch.float64)

REL = 1e-11          # values, means, variances: relative to the max
GRAD_REL = 1e-9      # gradients: of |g|max
COVPARMS = (1.0, 0.3, 0.5)
NUG = 0.2

# spec keyword sets of the V modes, on the module's data
CASES = {
    "zy": dict(m=8, cond_yz="zy"),
    "RVP": dict(m=8, cond_yz="RVP"),
    "LK": dict(m=8, cond_yz="LK"),
    "zy_pred": dict(m=8, pred=True),                    # vecchia_pred's
    "obspred": dict(m=8, pred=True, cond_yz="SGV", ordering_pred="obspred"),
    "mra_obspred": dict(m=6, pred=True, conditioning="mra"),
    "ic0": dict(m=8, cond_yz="SGV", ic0=True),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def make_data():
    """(locs, prediction locations, z): 70 observed points, 12 to
    predict, a Matern field plus nugget."""
    rng = np.random.default_rng(1988)
    n = 70
    locs = rng.uniform(size=(n, 2))
    z = rng.multivariate_normal(
        np.zeros(n), matern_np(cdist(locs, locs), COVPARMS)
        + NUG * np.eye(n))
    return locs, rng.uniform(size=(12, 2)), z


@pytest.fixture(scope="module")
def data():
    return make_data()


def make_spec(data, case):
    """(the port's spec of ``case``, the same arrays as the JAX package's
    spec)."""
    locs, locs_pred, _ = data
    kw = dict(CASES[case])
    if kw.pop("pred", False):
        kw["locs_pred"] = locs_pred
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec = GT.vecchia_specify(locs, **kw)
    return spec, jax_spec(spec)


_spec = make_spec


def _plans(spec, sj):
    return (TP.ensure_v(TP.get_plan(spec)),
            JP.ensure_v(JP.get_plan(sj, np.float64)))


# ------------------------------------------------------------ plan ----

@pytest.mark.parametrize("case", ["zy", "obspred", "mra_obspred", "ic0"])
def test_plan_v_arrays_match_jax(data, case):
    """ensure_v's pattern, physical layout and every schedule, array for
    array (the selected inverse's level maps too)."""
    tp, jp = _plans(*_spec(data, case))
    assert tp.mode == jp.mode and not tp.use_mf
    for f in ("v_nnz", "v_phys_size", "n_dir", "fwd_x_size", "bwd_x_size"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("v_colptr", "v_rows", "v_perm", "v_diag_slots", "dir_pt",
              "dir_nn", "fwd_x_perm", "bwd_x_perm"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    for name in ("w_schedule", "z2_schedule"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        np.testing.assert_array_equal(a.gather_map, b.gather_map)
        assert len(a.buckets) == len(b.buckets)
        for x, y in zip(a.buckets, b.buckets):
            for f in ("out_idx", "pa", "pb"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert len(tp.factor_buckets) == len(jp.factor_buckets)
    for x, y in zip(tp.factor_buckets, jp.factor_buckets):
        assert x.S == y.S
        np.testing.assert_array_equal(x.offsets, y.offsets)
        for cx, cy in zip(x.diag_classes + x.off_classes,
                          y.diag_classes + y.off_classes):
            assert len(cx) == len(cy)
            for ax, ay in zip(cx, cy):
                np.testing.assert_array_equal(ax, ay)
    for kind in ("fwd_blocks", "bwd_blocks"):
        for x, y in zip(getattr(tp, kind), getattr(jp, kind)):
            for f in x.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for x, y in zip(TS.build_selinv_levels(tp), JS.build_selinv_levels(jp)):
        assert x.F == y.F
        np.testing.assert_array_equal(x.slots, y.slots)
        np.testing.assert_array_equal(x.pair_slots, y.pair_slots)


def test_host_symbolic_and_levels_match_jax(data):
    """The host's symbolic Cholesky fill and solve levels (the port's
    bindings of its hostops.cpp) and ``symbolic.py``'s helpers equal the
    JAX package's, and the NumPy fallbacks equal the native functions."""
    from gpvecchia_tpu import csrc as jcsrc
    from gpvecchia_tpu import symbolic as JSY
    from gpvecchia_torch import symbolic as TSY
    from gpvecchia_torch.csrc import host
    rng = np.random.default_rng(11)
    n = 80
    rows = rng.integers(0, n, size=400)
    cols = rng.integers(0, n, size=400)
    W = TSY.csr_from_coo_lower(n, np.maximum(rows, cols),
                               np.minimum(rows, cols))
    W = TSY.csr_from_coo_lower(n, np.concatenate([
        np.repeat(np.arange(n), np.diff(W.indptr)), np.arange(n)]),
        np.concatenate([W.indices, np.arange(n)]))
    got = host.symbolic_chol_flat(W.indptr, W.indices, n)
    want = jcsrc.symbolic_chol_flat(W.indptr, W.indices, n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    colptr, rws, _ = got
    for d in ("fwd", "bwd"):
        np.testing.assert_array_equal(host.solve_levels(colptr, rws, n, d),
                                      jcsrc.solve_levels(colptr, rws, n, d))
    # the level and pattern helpers
    cols_native = TSY.symbolic_cholesky(W)[0]
    jcols = JSY.symbolic_cholesky(JSY.csr_from_coo_lower(
        n, np.repeat(np.arange(n), np.diff(W.indptr)), W.indices))[0]
    for a, b in zip(cols_native, jcols):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TSY.col_levels_backward(cols_native),
                                  JSY.col_levels_backward(jcols))
    a, b = TSY.cols_to_lower_csr(cols_native, n), JSY.cols_to_lower_csr(
        jcols, n)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    lev = rng.integers(0, 5, size=n)
    for x, y in zip(TSY.build_levels(lev), JSY.build_levels(lev)):
        np.testing.assert_array_equal(x, y)
    # the fallbacks (no native library)
    cols_native, parent, lev = TSY.symbolic_cholesky(W)
    orig = host.symbolic_chol
    host.symbolic_chol = lambda *a: None
    try:
        cols_np, parent_np, lev_np = TSY.symbolic_cholesky(W)
    finally:
        host.symbolic_chol = orig
    for a, b in zip(cols_native, cols_np):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(parent, parent_np)
    np.testing.assert_array_equal(lev, lev_np)
    orig = host.solve_levels
    host.solve_levels = lambda *a: None
    try:
        for d in ("fwd", "bwd"):
            np.testing.assert_array_equal(
                TP._solve_levels(colptr, rws, n, d),
                orig(colptr, rws, n, d))
    finally:
        host.solve_levels = orig


# --------------------------------------------------------- kernels ----

@pytest.mark.parametrize("case", ["zy", "obspred"])
def test_pair_sum_solves_and_selinv_match_jax(data, case):
    """pair_sum (the W schedule, or z2's; its pads on one zero and spread),
    the forward and backward solves and the selected inverse on a V with a
    dominant diagonal, against the JAX functions; a 2-D right-hand side
    solves as its columns do, and the logical layout is the physical one
    permuted."""
    tp, jp = _plans(*_spec(data, case))
    rng = np.random.default_rng(7)
    sched = tp.w_schedule or tp.z2_schedule
    jsched = jp.w_schedule or jp.z2_schedule
    n_a = 1 + max(int(b.pa.max()) for b in sched.buckets)
    n_b = 1 + max(int(b.pb.max()) for b in sched.buckets)
    A, B = rng.normal(size=n_a), rng.normal(size=n_b)
    for sizes in (None, (n_a, n_b)):
        got = TSP.pair_sum(torch.as_tensor(A), torch.as_tensor(B),
                           TSP.device_schedule(sched, "cpu", sizes=sizes))
        want = JSP.pair_sum(jnp.asarray(A), jnp.asarray(B), (
            [(jnp.asarray(b.pa), jnp.asarray(b.pb)) for b in jsched.buckets],
            jnp.asarray(jsched.gather_map)))
        assert _rel(got.numpy(), want) <= REL

    v = rng.uniform(0.1, 0.3, size=tp.v_phys_size)
    v[tp.v_diag_slots] = rng.uniform(1.0, 2.0, size=tp.n_lat)
    b = rng.normal(size=(tp.n_lat, 3))
    vt, bt = torch.as_tensor(v), torch.as_tensor(b)
    for solve_t, kind, solve_j, jblocks, size, perm in (
            (TT.forward_solve, "fwd", JT.forward_solve, jp.fwd_blocks,
             tp.fwd_x_size, tp.fwd_x_perm),
            (TT.backward_solve, "bwd", JT.backward_solve, jp.bwd_blocks,
             tp.bwd_x_size, tp.bwd_x_perm)):
        solve = TT.device_blocks(getattr(tp, kind + "_blocks"), "cpu", kind,
                                 tp.v_phys_size, size)
        x = solve_t(vt, bt[:, 0], solve).numpy()
        want = solve_j(jnp.asarray(v), jnp.asarray(b[:, 0]), jblocks,
                       x_size=size)
        assert _rel(x, want) <= REL
        x2 = solve_t(vt, bt, solve).numpy()
        for k in range(b.shape[1]):
            np.testing.assert_allclose(
                x2[:, k], solve_t(vt, bt[:, k], solve).numpy(),
                rtol=REL, atol=REL * np.max(np.abs(x2[:, k])))
        np.testing.assert_array_equal(
            solve_t(vt, bt, solve, torch.as_tensor(perm)).numpy(), x2[perm])

    got = TS.selected_inverse(vt, TS.device_selinv_levels(
        TS.build_selinv_levels(tp), "cpu"), tp.v_phys_size).numpy()
    want = JS.selected_inverse(jnp.asarray(v), JS.build_selinv_levels(jp),
                               jp.v_phys_size)
    real = np.zeros(tp.v_phys_size, bool)
    real[tp.v_perm] = True                # the pattern's slots, not the pads
    assert _rel(got[real], np.asarray(want)[real]) <= REL


def test_engine_never_sums_through_colliding_writes():
    """pair_sum, the solves, the factor, the selected inverse and H1's
    nugget-gradient reduction call no index_add_, scatter_add_,
    index_put_(accumulate=True), and no torch.gather or index_select (whose
    backward is a scatter-add): their values, and their gradients, do not
    depend on the order of atomics on the card."""
    root = pathlib.Path(GT.__file__).parent
    banned = {"index_add_", "index_add", "scatter_add_", "scatter_add",
              "scatter_reduce", "scatter_reduce_", "gather", "index_select"}
    for rel in ("linalg/sparse.py", "linalg/trisolve.py", "linalg/selinv.py",
                "inference/likelihood.py", "inference/prediction.py",
                "kernels/matern_solve.py"):
        for node in ast.walk(ast.parse((root / rel).read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in banned, (rel, node.attr)
            if isinstance(node, ast.keyword) and node.arg == "accumulate":
                assert not (isinstance(node.value, ast.Constant)
                            and node.value.value), rel


# ------------------------------------------------------ likelihood ----

@pytest.mark.parametrize("case", ["zy", "RVP", "LK", "obspred",
                                  "mra_obspred", "ic0"])
def test_likelihood_matches_jax(data, case):
    spec, sj = _spec(data, case)
    z = data[2]
    nug = np.linspace(0.1, 0.3, z.size)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = GT.vecchia_likelihood(z, spec, COVPARMS, nug, device="cpu")
        want = GJ.vecchia_likelihood(z, sj, COVPARMS, nug)
    assert abs(got - want) <= REL * abs(want)


@pytest.mark.parametrize("case,covmodel", [("zy", "matern"),
                                           ("obspred", "matern"),
                                           ("ic0", "esqe")])
def test_gradient_matches_jax(data, case, covmodel):
    """loglik_fn's value and gradient in (covparms, per-observation
    nuggets) against jax.value_and_grad (H5 on the built-in Matern, the
    packed path with esqe)."""
    spec, sj = _spec(data, case)
    z = data[2]
    cp = np.array(COVPARMS if covmodel == "matern" else (0.8, 0.5, 0.4, 0.2))
    nug = np.linspace(0.1, 0.3, z.size)
    fn = GT.loglik_fn(spec, covmodel, device="cpu")
    c = torch.tensor(cp, requires_grad=True)
    g = torch.tensor(nug, requires_grad=True)
    val = fn(z, c, g)
    dc, dg = torch.autograd.grad(val, (c, g))
    fj = GJ.loglik_fn(sj, covmodel)
    vj, (dcj, dgj) = jax.value_and_grad(
        lambda a, b: fj(jnp.asarray(z), a, b), argnums=(0, 1))(
            jnp.asarray(cp), jnp.asarray(nug))
    assert abs(val.item() - float(vj)) <= REL * abs(float(vj))
    scale = max(np.max(np.abs(dcj)), np.max(np.abs(dgj)))
    assert np.max(np.abs(dc.numpy() - dcj)) <= GRAD_REL * scale
    assert np.max(np.abs(dg.numpy() - dgj)) <= GRAD_REL * scale


def test_gradient_is_reproducible(data):
    """Two value+grads on the IC0 plan agree bit for bit."""
    spec, _ = _spec(data, "ic0")
    fn = GT.loglik_fn(spec, device="cpu")
    outs = []
    for _ in range(2):
        c = torch.tensor(COVPARMS, requires_grad=True)
        g = torch.tensor(NUG, requires_grad=True)
        val = fn(data[2], c, g)
        dc, dg = torch.autograd.grad(val, (c, g))
        outs.append(torch.cat([val.reshape(1), dc, dg.reshape(1)]))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("case", ["zy", "RVP", "LK", "ic0_full"])
def test_likelihood_matches_dense_oracle(data, case):
    """The zy family against the dense-U likelihood of the same spec, and
    IC0 with m = n - 1 (the pattern is complete: IC0 is the exact factor)
    against it too."""
    locs, _, z = data
    if case == "ic0_full":
        n = 40
        spec = GT.vecchia_specify(locs[:n], m=n - 1, cond_yz="SGV", ic0=True)
    else:
        n = z.size
        spec, _ = _spec(data, case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ll = GT.vecchia_likelihood(z[:n], spec, COVPARMS, NUG, device="cpu")
    want = dense_loglik(z[:n], jax_spec(spec), COVPARMS, NUG)
    assert abs(ll - want) <= 1e-9 * abs(want)


def test_zy_family_warns(data):
    """Every member of the family warns as the reference's zy does
    (tests/test_diagnostics.py::test_rvp_lk_get_zy_family_warning)."""
    for mode in ("zy", "RVP", "LK"):
        spec, _ = _spec(data, mode)
        with pytest.warns(UserWarning, match="poor likelihood"):
            GT.vecchia_likelihood(data[2], spec, COVPARMS, NUG, device="cpu")


# ------------------------------------------------------ host IC0 ----

def test_ic0_csr_and_ichol_match_jax_bit_for_bit():
    """ic0_csr on a Vecchia pattern and on random masks, ichol with a full
    mask (the exact Cholesky factor) and a partial one: the JAX package's
    loop's values exactly (tests/test_ic0_rvp.py's two ichol checks)."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(40, 40))
    M = A @ A.T + 40 * np.eye(40)
    L = ichol(M, np.ones_like(M))
    np.testing.assert_array_equal(L, jax_ichol(M, np.ones_like(M)))
    np.testing.assert_allclose(L, np.linalg.cholesky(M), atol=1e-10)
    S = rng.uniform(size=M.shape) < 0.3
    L = ichol(M, S)
    np.testing.assert_array_equal(L, jax_ichol(M, S))
    keep = np.tril((S | S.T) | np.eye(40, dtype=bool))
    assert np.all(L[~keep] == 0)
    np.testing.assert_allclose((L @ L.T)[keep], M[keep], rtol=1e-10)

    spec = GT.vecchia_specify(rng.uniform(size=(120, 2)), m=8,
                              conditioning="mra")
    ptrs, inds = TH._pattern_csr(spec)
    jptrs, jinds = JH._pattern_csr(jax_spec(spec))
    np.testing.assert_array_equal(ptrs, jptrs)
    np.testing.assert_array_equal(inds, jinds)
    row = np.repeat(np.arange(ptrs.size - 1), np.diff(ptrs))
    vals = rng.uniform(size=inds.size) + np.where(row == inds, 12.0, 0.0)
    np.testing.assert_array_equal(TH.ic0_csr(ptrs, inds, vals),
                                  JH.ic0_csr(ptrs, inds, vals))


@pytest.mark.parametrize("source", ["matern", "callable", "selected"])
def test_create_L_matches_jax(source):
    """create_L on an MRA spec (hierarchical: the exact HV factor) from a
    covariance name, a distance callable and the selected layout."""
    locs = np.random.default_rng(6).uniform(size=(100, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec = GT.vecchia_specify(locs, m=8, conditioning="mra")
    sj = jax_spec(spec)
    if source == "matern":
        args = ("matern", COVPARMS)
    elif source == "callable":
        args = (lambda d: np.exp(-d / 0.3),)
    else:
        args = (TH.get_mat_cov(spec, lambda d: np.exp(-d / 0.3)),)
    got = TH.create_L(spec, *args).toarray()
    want = JH.create_L(sj, *args).toarray()
    assert _rel(got, want) <= REL
    # L L^T holds the covariance on the (ancestor-closed) pattern
    K = np.exp(-cdist(locs, locs) / 0.3) if source != "matern" else \
        matern_np(cdist(locs, locs), COVPARMS)
    np.testing.assert_allclose(np.diag(got @ got.T), np.diag(K), rtol=1e-10)
