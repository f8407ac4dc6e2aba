"""Seconds of one of the benchmark's own host spans."""


def read(ctx, span):
    return ctx.spans.get(span)
