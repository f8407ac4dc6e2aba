"""A step's bytes and operations in the U-entry layer: H1 on every row of
the plan, and in a value+grad H5; at a smoothness without closed form the
general instances, with the pairs' operations counted on the step's own
inputs."""

from . import frozen


def step_cost(plan, step):
    """(bytes, operations) of one step."""
    args = (plan.sz, plan.n_all, plan.dim, plan.n_rows, plan.width)
    if step.general_ops is None:
        out = [frozen.cost_h1(*args)]
        if step.grad:
            out.append(frozen.cost_h5(*args))
    else:
        fwd, bwd = step.general_ops
        out = [frozen.cost_h1_general(*args, fwd)]
        if step.grad:
            out.append(frozen.cost_h5_general(*args, fwd, bwd))
    return out
