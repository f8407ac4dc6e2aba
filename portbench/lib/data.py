"""What a cell's inputs are made of, for the kinds of traffic to call:
the configuration's locations (fixed by the file), a traffic's sequence of
parameter points (fixed by its file), the Gaussian observations and the
generators drawn from ``--seed``."""

from __future__ import annotations

import math

import numpy as np
import torch

BOX_KEYS = ("sig2", "range", "nu", "nugget")


def rng(seed, stream):
    """A numpy generator for one use of the seed."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, stream]))


def locations(config):
    """(n, d) float64 uniform on the unit square, from the file's own
    seed."""
    r = np.random.default_rng(int(config["locations_seed"]))
    return r.uniform(size=(int(config["n"]), int(config["d"])))


def observations(locs, field, seed, device):
    """z (n,) float64 on ``device``, in the locations' order: a smooth
    random field (random Fourier features of the Matern of ``field``,
    frequencies and phases drawn on the host) plus the nugget's noise
    (drawn on the device)."""
    r = rng(seed, 0)
    R = int(field["features"])
    nu, rho = float(field["nu"]), float(field["range"])
    d = locs.shape[1]
    # the Matern's spectral density is a multivariate t with 2 nu degrees
    # of freedom, scaled by 1 / range
    omega = r.normal(size=(R, d)) / (rho * np.sqrt(
        r.chisquare(2.0 * nu, size=(R, 1))))
    phase = r.uniform(0.0, 2.0 * math.pi, size=R)
    om = torch.as_tensor(omega, dtype=torch.float64, device=device)
    ph = torch.as_tensor(phase, dtype=torch.float64, device=device)
    x = torch.as_tensor(locs, dtype=torch.float64, device=device)
    amp = math.sqrt(2.0 * float(field["sig2"]) / R)
    z = torch.empty(x.shape[0], dtype=torch.float64, device=device)
    for s in range(0, x.shape[0], 65536):
        z[s:s + 65536] = amp * torch.cos(x[s:s + 65536] @ om.T + ph).sum(1)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    noise = torch.randn(x.shape[0], generator=g, dtype=torch.float64,
                        device=device)
    return z + math.sqrt(float(field["nugget"])) * noise


def design(traffic, keys=BOX_KEYS):
    """(P, len(keys)) log-parameters in the order of ``keys``: the
    traffic's fixed set of points, a Latin hypercube of the log box drawn
    from the file's own ``design_seed``; a box side of one value pins that
    parameter."""
    P = int(traffic["design_points"])
    r = np.random.default_rng(int(traffic["design_seed"]))
    u = (np.stack([r.permutation(P) for _ in keys], axis=1)
         + r.uniform(size=(P, len(keys)))) / P
    box = traffic["box"]
    lo = np.log([box[k][0] for k in keys])
    hi = np.log([box[k][1] for k in keys])
    return lo + (hi - lo) * u


def points(traffic, count, keys=BOX_KEYS):
    """(count, len(keys)) log-parameters: the design's points in its
    order, pass after pass.  The sequence is the traffic's, not the
    seed's, so every seed asks for the same work in every window, whatever
    its length; the seed draws the data and which answers are checked."""
    d = design(traffic, keys)
    return np.resize(d, (count, d.shape[1]))
