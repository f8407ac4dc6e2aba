"""The share of the traced window in which no operation ran on the
device."""


def read(ctx):
    if not ctx.window_s or not ctx.ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
