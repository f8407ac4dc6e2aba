"""Device milliseconds a step of the operations that belong to none of the
port's kernel layers: torch's elementwise kernels, copies, fills and
library calls."""


def read(ctx):
    if not ctx.steps or not ctx.ops:
        return None
    return 1e3 * ctx.device_s(None) / ctx.steps
