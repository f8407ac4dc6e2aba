"""``correct``: the program's answers at a sample of the window's steps,
drawn from the seed, against the plain reference at the same inputs."""

from __future__ import annotations

import math

import numpy as np


def _finite(x):
    return x is not None and all(math.isfinite(v) for v in np.ravel(x))


def compare(traffic, outs, pts, prob, seed_rng):
    """(correct, {name: {"value", "limit"}}): the widest relative gap of the
    value, of the gradient (by its largest entry, against the reference's
    largest), and the rows the reference had to drop, over
    ``traffic["check_steps"]`` sampled steps."""
    limits = traffic["check"]
    grad = traffic["entry"] == "neg_loglik_value_grad"
    closed = traffic["box"]["nu"] == [0.5, 0.5]
    k = min(len(outs), int(traffic["check_steps"]))
    pick = sorted(seed_rng.choice(len(outs), size=k, replace=False).tolist())
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
