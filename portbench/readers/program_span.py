"""Seconds of the program's own spans, read from its in-process table
(``gpvecchia_torch.utils.trace``) after the window.

``spans``: span names, each taken with every depth of ``depths`` (an
inclusive [first, last]) appended when given (``"mf.fwd.d"`` with [0, 3]
reads ``mf.fwd.d0`` to ``mf.fwd.d3``); ``time``: ``host``, ``self`` (host
less the child spans) or ``device`` (the spans' device intervals);
``per``: ``step`` reads the traced window's section of the table, in
milliseconds a step, ``run`` the whole run's, in seconds.  None where the
program keeps no such table or no such span, and for ``device`` where no
span has a device interval (no CUDA stream, as on the CPU)."""

from __future__ import annotations

KEYS = {"host": "host_s", "self": "self_s", "device": "device_s"}


def program_table(profiled):
    """The program's trace table, or None where the program has none."""
    try:
        from gpvecchia_torch.utils import trace
    except ImportError:
        return None
    return trace.table(profiled=profiled)


def names(spans, depths=None):
    if depths is None:
        return list(spans)
    return [f"{s}{k}" for s in spans for k in range(depths[0], depths[1] + 1)]


def read(ctx, spans, time="host", per="step", depths=None):
    tab = program_table(per == "step")
    if tab is None:
        return None
    vals = [tab[n][KEYS[time]] for n in names(spans, depths) if n in tab]
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    if per == "run":
        return sum(vals)
    if not ctx.steps:
        return None
    return sum(vals) / ctx.steps * 1e3
