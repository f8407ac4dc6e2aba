"""The whole step's operations (every kernel layer's count) over the
window's length times the dtype's peak."""


def read(ctx):
    if not ctx.window_s or not ctx.ops or not ctx.flops:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * ctx.peak_flops)
