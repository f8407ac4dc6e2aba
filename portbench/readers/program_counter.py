"""A counter of the program's own (``gpvecchia_torch.utils.trace``) over
the traced window, a step: 0 where the program counted nothing under that
name, None where it keeps no such table."""

from __future__ import annotations

from .program_span import program_table


def read(ctx, counter):
    tab = program_table(True)
    if tab is None or not ctx.steps:
        return None
    return tab.get(counter, {"count": 0})["count"] / ctx.steps
