"""What the Gaussian likelihood's kinds share; not a kind (it has no
``Entry``).  Their inputs are a Matern field's observations plus the
nugget's noise, their points the log box (sig2, range, nu, nugget), their
check the reference's Gaussian likelihood, and a step one U-entry pass
and one factor, priced at the step's own range and smoothness where the
Matern has no closed form."""

from __future__ import annotations

import itertools
import math

import torch

from portbench import reference
from portbench.lib import check as chk
from portbench.lib import data, entries
from portbench.lib.trace import Step

GEN_ROW_STRIDE = 16       # rows between those whose pairs' terms are counted


def inputs(locs, traffic, seed, device):
    """z (n,) float64 on ``device``, in the locations' order."""
    return data.observations(locs, traffic["field"], seed, device)


def points(traffic, count):
    return data.points(traffic, count)


def check(traffic, outs, pts, ref_arrays, locs, inputs_host, seed_rng,
          device, grad):
    prob = reference.problem(ref_arrays, locs, inputs_host, device)
    return chk.gaussian(traffic, outs, pts, prob, seed_rng, grad)


def passes(spec, traffic, pts, dtype, device, entry):
    """A pass a step: at a smoothness without closed form, the pairs'
    operations at each step's range and smoothness, counted on every
    GEN_ROW_STRIDE-th row."""
    from portbench.costs import frozen
    nu = traffic["box"]["nu"]
    if nu[0] == nu[1] and float(nu[0]) in (0.5, 1.5, 2.5):
        return [Step(grad=entry.grad, general_ops=None)] * len(pts)
    _, locs, NN = entries.plan_shapes(spec)
    lt = torch.as_tensor(locs, device=device)
    nt = torch.as_tensor(NN, device=device)
    vt = nt >= 0
    return [Step(grad=entry.grad, general_ops=frozen.gen_ops(
        lt, nt, vt, math.exp(lg[1]), math.exp(lg[2]), dtype,
        row_stride=GEN_ROW_STRIDE)) for lg in pts]


def corners(spec, z, traffic, device):
    """The port's log-likelihood and the rows it drops at the corners and
    the centre of the traffic's box, in float64 and float32."""
    from gpvecchia_torch import loglik_fn
    box = traffic["box"]
    keys = data.BOX_KEYS
    pts = [dict(zip(keys, c)) for c in itertools.product(
        *[box[k] for k in keys])]
    pts.append({k: math.sqrt(box[k][0] * box[k][1]) for k in keys})
    for name in ("float64", "float32"):
        dt = entries.DTYPES[name]
        fn = loglik_fn(spec, device=device, dtype=dt, with_aux=True)
        for p in pts:
            cp = torch.tensor([p["sig2"], p["range"], p["nu"]],
                              dtype=torch.float64)
            ll, aux = fn(z.to(dt), cp, p["nugget"])
            yield {"dtype": name, **p, "loglik": float(ll),
                   "dropped": int(aux["n_dropped_rows"])}
