"""A derivative-free search's step: ``loglik_fn(spec)(z, covparms,
nugget)`` on the Gaussian observations with the smoothness fixed by the
traffic, the value alone, checked against the reference's likelihood."""

from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

from . import _gaussian


class Entry:
    """The log-likelihood with z on the card, read back; returned as minus
    the log-likelihood, as the L-BFGS-B kind's objective."""

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


inputs, points = _gaussian.inputs, _gaussian.points
passes, corners = _gaussian.passes, _gaussian.corners
check = functools.partial(_gaussian.check, grad=False)
