"""``correct``'s parts for the kinds of traffic: which of the window's
steps are checked, drawn from the seed, and the comparison of a Gaussian
likelihood's answers with the plain reference at the same inputs."""

from __future__ import annotations

import math

import numpy as np


def _finite(x):
    return x is not None and all(math.isfinite(v) for v in np.ravel(x))


def sample_steps(n_steps, traffic, seed_rng):
    """The sorted indices of ``traffic["check_steps"]`` of the window's
    ``n_steps`` steps (all of them where the window ran fewer)."""
    k = min(n_steps, int(traffic["check_steps"]))
    return sorted(seed_rng.choice(n_steps, size=k, replace=False).tolist())


def gaussian(traffic, outs, pts, prob, seed_rng, grad):
    """(correct, {name: {"value", "limit"}}, the steps checked): the widest
    relative gap of the value, with ``grad`` of the gradient too (by its
    largest entry, against the reference's largest), and the rows the
    reference (``reference.likelihood.Problem``) had to drop, over the
    sampled steps."""
    limits = traffic["check"]
    closed = traffic["box"]["nu"] == [0.5, 0.5]
    pick = sample_steps(len(outs), traffic, seed_rng)
    worst = {"value_rel": 0.0}
    if grad:
        worst["grad_rel"] = 0.0
    dropped = 0
    for i in pick:
        v, g = outs[i]
        if grad:
            rv, rg, bad = prob.value_grad(pts[i], closed)
        else:
            (rv, bad), rg = prob.value(pts[i], closed), None
        dropped = max(dropped, bad)
        gaps = {"value_rel": abs(v - rv) / abs(rv) if _finite(v)
                else math.inf}
        if grad:
            rg = np.asarray(rg)
            gaps["grad_rel"] = (float(np.abs(np.asarray(g) - rg).max()
                                      / np.abs(rg).max())
                                if _finite(g) else math.inf)
        for name, gap in gaps.items():
            worst[name] = max(worst[name], gap)
    checks = {name: {"value": val, "limit": float(limits[name])}
              for name, val in worst.items()}
    checks["ref_dropped_rows"] = {"value": dropped, "limit": 0}
    correct = bool(pick) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return correct, checks, pick
