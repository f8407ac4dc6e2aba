"""The ranks' side of the sharded tests (``test_torch_mesh.py``,
``test_torch_mcmc.py``): functions that ``parallel.mesh.run_local`` runs in
spawned processes.

The ranks import this module by name, so it imports neither jax nor the
JAX package: the references are computed by the tests, in the parent.
Every rank function returns plain numpy data.
"""

import warnings

import numpy as np
import torch

import gpvecchia_torch as GT
from gpvecchia_torch.fit import mcmc as TM
from gpvecchia_torch.inference.likelihood import loglik_fn
from gpvecchia_torch.parallel import mesh as PM
from gpvecchia_torch.utils import trace

# tests/test_mesh.py's problem
N, M, SEED = 600, 12, 1988
COVPARMS = np.array([1.3, 0.25, 0.5])
NUG = 0.15
# the V plans' problem (the per-entry V engine's host set-up grows fast
# with n; these keep a rank's share of it small)
V_N, V_M = 100, 6
V_CASES = {"zy": dict(cond_yz="zy"), "ic0": dict(cond_yz="SGV", ic0=True)}
# test_mesh.py's test_mf_levels_sharded_and_collectives_emitted problem
TREE_N, TREE_M, TREE_SEED = 5000, 10, 7
# the sampler's problem (test_torch_mcmc.py's smoke test, shorter)
CHAIN_KW = dict(covmodel="matern", theta_ini=[1.0, 0.3, 0.5, 0.1],
                num_warmup=2, num_samples=2, algorithm="hmc", n_leap=2,
                seed=2, device="cpu")


def problem(n=N, m=M, seed=SEED, **kw):
    """(spec, z): uniform locations, then standard normal data."""
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec = GT.vecchia_specify(locs, m=m, **({"cond_yz": "SGV"} | kw))
    return spec, rng.normal(size=n)


def v_problem(case):
    return problem(V_N, V_M, **V_CASES[case])


def chain_problem():
    rng = np.random.default_rng(3)
    locs = rng.uniform(size=(60, 2))
    z = rng.normal(size=60)
    return GT.vecchia_specify(locs, m=5), z


def value_grad(fn, z, nug, covparms=COVPARMS):
    """(value, d covparms, d nuggets) of ``fn`` in float64."""
    c = torch.tensor(covparms, dtype=torch.float64, requires_grad=True)
    g = torch.tensor(nug, dtype=torch.float64, requires_grad=True)
    v = fn(z, c, g)
    dc, dg = torch.autograd.grad(v, (c, g))
    return float(v.detach()), dc.numpy(), dg.numpy()


def tree_share(dev):
    """What a rank's share of the tree holds: its own levels' node counts,
    the top's, its rows (elements) and the rows its U entries cover."""
    mf = dev["mf"]
    return dict(own_N=[lv["piv_ids"].shape[0] for lv in mf],
                top_N=[lv["piv_ids"].shape[0] for lv in (mf.top or [])],
                depth=len(mf) + len(mf.top or []) - 1,
                elems=None if mf.elems is None else mf.elems.copy(),
                u_rows=int(dev["NN"].shape[0]))


def _exchanges():
    """This rank's exchanges since the trace table was last emptied."""
    tab = trace.table()
    return {k: tab.get(f"mesh.exchange.{k}", {"count": 0})["count"]
            for k in ("calls", "bytes")}


def one_thread():
    """One intra-op thread a rank: the ranks share the machine with other
    test workers, and MKL gives a loaded process fewer threads than asked,
    which moves the last bits of its products from call to call."""
    torch.set_num_threads(1)


def mesh_rank(rank, world):
    """Every quantity the sharded tests hold, for one world size: the
    likelihood and its gradients, twice; the posterior; the V plans; the
    share of the tree; the chains axis (4 ranks); a mesh the group cannot
    form."""
    one_thread()
    out = {}
    mesh = PM.make_mesh(device_type="cpu")
    spec, z = problem()
    fn = PM.sharded_loglik_fn(spec, mesh=mesh, device="cpu")
    out["vec"] = value_grad(fn, z, np.full(N, NUG))
    out["scalar"] = value_grad(fn, z, NUG)
    out["again"] = value_grad(fn, z, np.full(N, NUG))
    core, sdev = PM.sharded_posterior_core(spec, mesh=mesh, device="cpu")
    out["post"] = [t.numpy() for t in core(sdev, z, COVPARMS, NUG)]
    out["tree"] = tree_share(sdev)
    for case in V_CASES:
        vspec, vz = v_problem(case)
        vfn = PM.sharded_loglik_fn(vspec, mesh=mesh, device="cpu")
        out[case] = value_grad(vfn, vz, NUG)
    try:
        PM.make_mesh(rows=world + 1, device_type="cpu")
    except ValueError as e:
        out["mesh_error"] = str(e)
    if world == 4:
        cmesh = PM.make_mesh(rows=2, chains=2, device_type="cpu")
        c = cmesh.get_local_rank("chains")
        cfn = PM.sharded_loglik_fn(spec, mesh=cmesh, device="cpu")
        out["chains"] = (c, float(cfn(z, COVPARMS * (1.0, 1.1)[c],
                                      np.full(N, NUG))))
        tspec, tz = problem(TREE_N, TREE_M, TREE_SEED)
        trace.reset()
        tfn, tdev = PM.sharded_loglik_core(tspec, mesh=mesh, device="cpu")
        nug = np.full(TREE_N, NUG)
        out["tree_big"] = dict(tree_share(tdev), value=float(tfn(
            tdev, tz, COVPARMS, nug)), exchanges=_exchanges())
        if rank == 0:
            out["tree_big"]["unsharded"] = float(loglik_fn(
                tspec, device="cpu")(tz, COVPARMS, nug))
    return out


def chains_rank(rank, world):
    """``sample_posterior`` over a (chains=world, rows=1) mesh, and the
    error of a chain count that does not divide."""
    one_thread()
    spec, z = chain_problem()
    mesh = PM.make_mesh(rows=1, chains=world, device_type="cpu")
    out = TM.sample_posterior(spec, z, num_chains=2, mesh=mesh, **CHAIN_KW)
    try:
        TM.sample_posterior(spec, z, num_chains=3, mesh=mesh, **CHAIN_KW)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def failing_rank(rank, world):
    """Rank 1 raises while the others wait for it in a collective."""
    if rank == 1:
        raise ArithmeticError("rank 1 gives up")
    torch.distributed.barrier()
    return rank
