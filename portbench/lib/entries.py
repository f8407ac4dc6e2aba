"""The system under test: the port's public entry points as a traffic mix
drives them, one step a call.  Only this module and the spec cache import
the port."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def build_spec(locs, config):
    from gpvecchia_torch.spec import vecchia_specify
    return vecchia_specify(locs, **config["specify"])


class NegLoglikValueGrad:
    """``fit.mle.neg_loglik_fn``'s objective in the log-parameters (sig2,
    range, nu, nugget) with its gradient, both read back to the host, as
    L-BFGS-B asks for them."""

    grad = True

    def __init__(self, spec, z, traffic, dtype, device):
        from gpvecchia_torch.fit.mle import neg_loglik_fn
        self.f = neg_loglik_fn(spec, z.cpu().numpy(), 4, device=device,
                               dtype=dtype)

    def __call__(self, lg):
        with record_function("portbench.upload"):
            lgt = torch.tensor(lg, dtype=torch.float64, requires_grad=True)
        v = self.f(lgt)
        (g,) = torch.autograd.grad(v, lgt)
        with record_function("portbench.readback"):
            return float(v.detach()), g.tolist()


class LoglikValue:
    """``loglik_fn(spec)(z, covparms, nugget)`` with z on the card and the
    smoothness fixed by the traffic; the value read back.  Returned as
    minus the log-likelihood, as the other entries."""

    grad = False

    def __init__(self, spec, z, traffic, dtype, device):
        from gpvecchia_torch import loglik_fn
        self.f = loglik_fn(spec, device=device, dtype=dtype)
        self.z = z.to(dtype)
        self.nu = float(traffic["box"]["nu"][0])

    def __call__(self, lg):
        with record_function("portbench.upload"):
            th = torch.exp(torch.as_tensor(lg, dtype=torch.float64))
            cp = torch.tensor([float(th[0]), float(th[1]), self.nu],
                              dtype=torch.float64)
            nug = float(th[3])
        v = self.f(self.z, cp, nug)
        with record_function("portbench.readback"):
            return -float(v), None


ENTRIES = {"neg_loglik_value_grad": NegLoglikValueGrad,
           "loglik_value": LoglikValue}


def make(spec, z, traffic, dtype, device):
    return ENTRIES[traffic["entry"]](spec, z, traffic, dtype, device)


def plan_shapes(spec):
    """What the yardstick reads of the run's plan: the multifrontal plan
    and the U rows' shapes."""
    from gpvecchia_torch.plan import get_mf_plan, get_plan
    plan = get_plan(spec)
    mf, _ = get_mf_plan(plan)
    return mf, np.asarray(plan.locs), np.asarray(plan.NN)
