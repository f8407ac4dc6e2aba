"""A step's bytes and operations in the assembly layer: H2 at the leaf
and H3 at every internal level of the multifrontal plan; in a value+grad
also their pullbacks H7 and H6."""

from . import frozen


def step_cost(plan, step):
    """(bytes, operations) of each launch of one step."""
    mf, sz = plan.mf, plan.sz
    out = []
    leaf = mf.levels[mf.depth]
    N = leaf.piv_ids.shape[0]
    F1 = leaf.npiv + leaf.nbord + 1
    n_in, ops = frozen.leaf_inputs(leaf, F1)
    out.append(frozen.cost_h2(sz, N, F1, leaf.elem_pos, n_in, ops))
    if step.grad:
        out.append(frozen.cost_h7(sz, N, F1, leaf.elem_pos, leaf.elem_pt,
                                  ops))
    for d in range(mf.depth):
        lv, lc = mf.levels[d], mf.levels[d + 1]
        N = lv.piv_ids.shape[0]
        F1 = lv.npiv + lv.nbord + 1
        Bc1 = lc.nbord + 1
        ext = frozen.ext_aug(lv, F1, Bc1)
        out.append(frozen.cost_h3(sz, N, F1, ext))
        if step.grad:
            out.append(frozen.cost_h6(sz, N, F1, Bc1, ext))
    return out
