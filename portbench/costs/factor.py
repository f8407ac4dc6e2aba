"""A step's bytes and operations in the factor layer: H4 at every level
of the multifrontal plan, and in a value+grad H9 too."""

from . import frozen


def step_cost(plan, step):
    """(bytes, operations) of each launch of one step."""
    out = []
    for lv in plan.mf.levels:
        N = lv.piv_ids.shape[0]
        F1 = lv.npiv + lv.nbord + 1
        out.append(frozen.cost_h4(plan.sz, N, F1, lv.npiv))
        if step.grad:
            out.append(frozen.cost_h9(plan.sz, N, F1, lv.npiv))
    return out
