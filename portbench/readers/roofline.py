"""A layer's share of its roofline: the least time the card could take for
the layer's launches in the window (each launch's larger of bytes over the
HBM rate and operations over the dtype's peak) over the device time of the
layer's kernels there."""


def read(ctx, layer):
    t = ctx.device_s(layer)
    bound = ctx.bound_s.get(layer)
    if not t or not bound:
        return None
    return 100.0 * bound / t
