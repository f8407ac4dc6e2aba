"""Device operations (kernels, copies, fills) in the window a step."""


def read(ctx):
    if not ctx.steps or not ctx.ops:
        return None
    return len(ctx.ops) / ctx.steps
