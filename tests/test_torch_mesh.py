"""Sharding over processes: the port's ``parallel/mesh.py`` vs the JAX
package's on the CPU, in float64.

``tests/test_mesh.py`` on its problem (rng 1988, n=600, m=12, SGV,
covparms (1.3, 0.25, 0.5), nugget 0.15): the ranks run under
``run_local`` on gloo, one spawn per world size computing every quantity
at once (``torch_mesh_ranks.mesh_rank``, a module that imports no JAX);
the JAX references, ``loglik_fn`` / ``jax.grad`` and the JAX package's
sharded cores on as many virtual CPU devices, are computed here.  The
gradient cases at R = 2 and 4 catch a term counted R times.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpvecchia_tpu.inference.likelihood import loglik_fn as jax_loglik_fn
from gpvecchia_tpu.parallel import mesh as JM

import torch_mesh_ranks as MR
from gpvecchia_torch.inference.likelihood import loglik_fn
from gpvecchia_torch.inference.prediction import _pred_fns
from gpvecchia_torch.parallel import mesh as PM

from test_torch_prediction import jax_spec

VAL_REL = 1e-12      # values, posterior means and variances
GRAD_REL = 1e-10     # gradients
SPAWN_S = 300.0      # a spawn's time limit


@pytest.fixture(scope="module")
def sharded():
    """sharded(R) -> every rank's results at R ranks (one spawn each)."""
    runs = {}

    def get(R):
        if R not in runs:
            runs[R] = PM.run_local(MR.mesh_rank, R, backend="gloo",
                                   device="cpu", timeout=SPAWN_S)
        return runs[R]

    return get


def _jvg(spec, z, nug):
    """(value, d covparms, d nuggets) of the JAX package's loglik_fn."""
    fj = jax_loglik_fn(jax_spec(spec), "matern")
    zj, c, g = jnp.asarray(z), jnp.asarray(MR.COVPARMS), jnp.asarray(nug)
    v, (dc, dg) = jax.value_and_grad(lambda c, g: fj(zj, c, g),
                                     argnums=(0, 1))(c, g)
    return float(v), np.asarray(dc), np.asarray(dg)


@pytest.fixture(scope="module")
def ref():
    """The JAX references of the main problem and the V plans.  The scalar
    nugget's derivative is the sum of the per-observation ones at equal
    nuggets (one JAX compile fewer)."""
    spec, z = MR.problem()
    vec = _jvg(spec, z, np.full(MR.N, MR.NUG))
    out = {"spec": spec, "z": z, "vec": vec,
           "scalar": (vec[0], vec[1], np.sum(vec[2]))}
    for case in MR.V_CASES:
        out[case] = _jvg(*MR.v_problem(case), MR.NUG)
    return out


def _jax_sharded_value(spec, z, ndev):
    mesh = JM.make_mesh(jax.devices()[:ndev], chains=1)
    core, sdev = JM.sharded_loglik_core(jax_spec(spec), "matern", mesh=mesh)
    return float(jax.jit(core)(sdev, jnp.asarray(z),
                               jnp.asarray(MR.COVPARMS),
                               jnp.full(MR.N, MR.NUG)))


@pytest.mark.parametrize("R", [2, 4, pytest.param(8, marks=pytest.mark.slow)])
def test_sharded_matches_unsharded(sharded, ref, R):
    """Every rank's value equals JAX's loglik_fn and JAX's sharded core on
    R virtual devices, and all ranks hold the same bits."""
    vals = [o["vec"][0] for o in sharded(R)]
    assert len(set(vals)) == 1, vals
    np.testing.assert_allclose(vals[0], ref["vec"][0], rtol=VAL_REL)
    np.testing.assert_allclose(
        vals[0], _jax_sharded_value(ref["spec"], ref["z"], R), rtol=VAL_REL)


def _assert_grads(got, want):
    """(d covparms, d nuggets) to GRAD_REL of each one's largest entry
    (the closed-form smoothness's derivative is 0 in both)."""
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_REL,
                                   atol=GRAD_REL * np.max(np.abs(w)))


@pytest.mark.parametrize("R", [2, 4])
def test_sharded_gradient_matches(sharded, ref, R):
    """The gradient in covparms and in a per-observation nugget vector, and
    in covparms and a scalar nugget, on every rank, against jax.grad."""
    for o in sharded(R):
        _assert_grads(o["vec"], ref["vec"])
        _assert_grads(o["scalar"], ref["scalar"])
        assert o["scalar"][2].shape == ()


@pytest.mark.parametrize("R", [2, 4])
def test_two_sharded_value_grads_agree_bit_for_bit(sharded, R):
    for o in sharded(R):
        assert o["vec"][0] == o["again"][0]
        for a, b in zip(o["vec"][1:], o["again"][1:]):
            np.testing.assert_array_equal(a, b)


def test_chains_axis(sharded, ref):
    """(chains=2, rows=2): chain 0 evaluates covparms, chain 1 covparms *
    1.1, each over two row ranks."""
    by_chain = {}
    for o in sharded(4):
        c, v = o["chains"]
        by_chain.setdefault(c, set()).add(v)
    assert all(len(v) == 1 for v in by_chain.values())
    v0, v1 = by_chain[0].pop(), by_chain[1].pop()
    np.testing.assert_allclose(v0, ref["vec"][0], rtol=VAL_REL)
    assert v0 != v1


def test_tree_is_sharded(sharded):
    """At R=4 on test_mesh.py's n=5000, m=10 problem: each rank's levels
    from depth 2 down hold N/4 nodes, the two levels above are replicated,
    each rank's U entries cover exactly its leaves' elements (the four
    sets partition the rows), the exchange ran, and the value equals the
    unsharded port's."""
    outs = sharded(4)
    t0 = outs[0]["tree_big"]
    D = t0["depth"]
    assert D >= 4
    for o in outs:
        t = o["tree_big"]
        assert t["top_N"] == [1, 2]
        assert t["own_N"] == [2 ** d // 4 for d in range(2, D + 1)]
        assert t["u_rows"] == t["elems"].size
        assert t["exchanges"]["calls"] > 0 and t["exchanges"]["bytes"] > 0
        np.testing.assert_allclose(t["value"], t0["unsharded"], rtol=VAL_REL)
    rows = np.concatenate([o["tree_big"]["elems"] for o in outs])
    np.testing.assert_array_equal(np.sort(rows), np.arange(MR.TREE_N))


@pytest.mark.parametrize("case", list(MR.V_CASES))
@pytest.mark.parametrize("R", [2, 4])
def test_v_plans_sharded(sharded, ref, case, R):
    """A V plan (the per-entry engine runs replicated over row-sharded U
    entries): value and gradient equal the unsharded port's and JAX's."""
    spec, z = MR.v_problem(case)
    want = MR.value_grad(loglik_fn(spec, device="cpu"), z, MR.NUG)
    for o in sharded(R):
        got = o[case]
        np.testing.assert_allclose(got[0], want[0], rtol=VAL_REL)
        np.testing.assert_allclose(got[0], ref[case][0], rtol=VAL_REL)
        # the zy family's likelihood does not depend on covparms (its
        # gradient there is rounding): the joint largest entry
        scale = max(np.max(np.abs(w)) for w in ref[case][1:])
        for g, w, j in zip(got[1:], want[1:], ref[case][1:]):
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * scale)
            np.testing.assert_allclose(g, j, rtol=0, atol=GRAD_REL * scale)


@pytest.fixture(scope="module")
def posterior_ref(ref):
    """(the JAX package's sharded posterior on 2 devices, the unsharded
    port's (mu, diag))."""
    spec, z = ref["spec"], ref["z"]
    mesh = JM.make_mesh(jax.devices()[:2], chains=1)
    core, sdev = JM.sharded_posterior_core(jax_spec(spec), "matern",
                                           mesh=mesh)
    jmu, jvar = jax.jit(core)(sdev, jnp.asarray(z), jnp.asarray(MR.COVPARMS),
                              jnp.full(MR.N, MR.NUG))
    (mean_fn, var_fn), _ = _pred_fns(spec, "matern", torch.device("cpu"),
                                     torch.float64)
    mu, fac = mean_fn(z, MR.COVPARMS, np.full(MR.N, MR.NUG))
    return (np.asarray(jmu), np.asarray(jvar)), (mu.numpy(),
                                                 var_fn(fac).numpy())


@pytest.mark.parametrize("R", [2, 4])
def test_sharded_posterior(sharded, posterior_ref, R):
    for o in sharded(R):
        for want in posterior_ref:
            for g, w in zip(o["post"], want):
                np.testing.assert_allclose(g, w, rtol=VAL_REL,
                                           atol=VAL_REL * np.max(np.abs(w)))


@pytest.mark.parametrize("case", list(MR.V_CASES))
def test_sharded_posterior_refuses_v_plans(case):
    """As the JAX package's: the sharded posterior needs the multifrontal
    factor."""
    spec, _ = MR.v_problem(case)
    with pytest.raises(NotImplementedError, match="multifrontal"):
        PM.sharded_posterior_core(spec, device="cpu")
    with pytest.raises(NotImplementedError, match="multifrontal"):
        JM.sharded_posterior_core(jax_spec(spec), "matern")


def test_make_mesh_refuses_a_group_that_cannot_form_it(sharded):
    with pytest.raises(ValueError, match="no process group"):
        PM.make_mesh(device_type="cpu")
    for o in sharded(2):
        assert "cannot form a (chains=1, rows=3) mesh" in o["mesh_error"]


def test_run_local_names_the_failing_rank():
    """Rank 1 raises while rank 0 waits for it in a barrier: run_local
    raises at once, naming rank 1 and its error, and returns nothing."""
    with pytest.raises(RuntimeError, match=r"rank 1 failed(.|\n)*"
                       r"ArithmeticError: rank 1 gives up"):
        PM.run_local(MR.failing_rank, 2, backend="gloo", device="cpu",
                     timeout=SPAWN_S)


def test_run_local_defaults_to_the_card(monkeypatch):
    """Without ``device`` the ranks run on the card: with none visible,
    run_local raises before it starts a rank, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        PM.run_local(MR.failing_rank, 2, backend="gloo", timeout=SPAWN_S)
