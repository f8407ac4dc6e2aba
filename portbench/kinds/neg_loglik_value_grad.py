"""An L-BFGS-B step: ``fit.mle.neg_loglik_fn``'s objective in the
log-parameters (sig2, range, nu, nugget) with its gradient, on the
Gaussian observations, checked against the reference's likelihood."""

from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

from . import _gaussian


class Entry:
    """The objective and its gradient, both read back to the host, as
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


inputs, points = _gaussian.inputs, _gaussian.points
passes, corners = _gaussian.passes, _gaussian.corners
check = functools.partial(_gaussian.check, grad=True)
