"""The port's spans and counters: one in-memory table for the process.

``span(name)`` times a phase of the program (a context manager and a
decorator); ``count(name, n)`` adds to a counter.  Both always add to the
table, which holds aggregates keyed by name, never one record per call:

* a span: its calls, host seconds, self seconds (host seconds less those of
  its child spans: a span's parent is the innermost span open on the same
  thread; autograd runs the backward on a thread of its own, which has its
  own stack), the parents it was opened under, and its device seconds
  where it recorded any;
* a counter: its count.

While torch's profiler records, or inside ``recording()``, a span also
opens ``torch.profiler.record_function("gpv." + name)``, so that it sits on
the profiler's timeline beside the kernels it launched, and, once CUDA is
in use, a pair of timing events on the current stream, which give its
device interval.  The events are resolved when the table is read (or once
many are pending, those that have completed), never by waiting on the card
on the hot path.  What was added while the profiler recorded is kept again
in a section of its own: ``table(profiled=True)``.

Counters count from shapes and dtypes only and never read a device value.
The program's names:

* spans: ``plan.likelihood``, ``plan.mf``, ``plan.device_arrays``,
  ``plan.covmodel``, ``spec.load``, ``build.cuda``, ``build.hostops``,
  ``loglik``, ``u_entries``, ``u_entries.bwd``, ``mf.fwd`` with a child
  ``mf.fwd.d<depth>`` for each level of the multifrontal tree (depth 0 is
  the root) and ``mf.bwd`` with ``mf.bwd.d<depth>``;
* counters: ``launches.<kernel>`` for each kernel launch (and each call of
  H9's plain version, ``launches.front_factor_vjp``),
  ``front_factor_bwd.cuda_launches`` (the CUDA launches H9 makes, summed
  over its calls), ``build.cuda.done`` and ``build.hostops.done``,
  ``mesh.exchange.calls`` and ``mesh.exchange.bytes``, ``sync.host`` (each
  time step code waits on the card: a read of a device tensor on the host,
  a copy between devices) and ``copy.bytes`` (the bytes those moved).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "sync", "to", "recording", "table", "reset"]

_lock = threading.Lock()
_local = threading.local()
_forced = 0              # open ``recording()`` blocks
# [the whole run, the profiled section]: name -> [calls, host ns, self ns,
# device ms or None, {parent: calls}] for a span, name -> count for a counter
_spans = ({}, {})
_counts = ({}, {})
# (name, start event, end event) of spans recorded while profiling, not
# resolved yet
_pending = []
_PENDING_MAX = 4096


if hasattr(_profiler, "_is_profiler_enabled"):
    def _recording() -> bool:
        return _forced > 0 or _profiler._is_profiler_enabled
else:
    def _recording() -> bool:
        return _forced > 0 or torch._C._autograd._profiler_enabled()


def _add(sec, name, dt, self_ns, parent):
    e = sec.get(name)
    if e is None:
        e = sec[name] = [0, 0, 0, None, {}]
    e[0] += 1
    e[1] += dt
    e[2] += self_ns
    if parent is not None:
        e[4][parent] = e[4].get(parent, 0) + 1


class span:
    """A phase of the program under ``name``: ``with span(name): ...`` or
    ``@span(name)`` on a function.  Re-entrant and thread-safe: what a call
    needs lives on its thread's stack, not on the object."""

    __slots__ = ("name", "_tag")

    def __init__(self, name: str):
        self.name = name
        self._tag = "gpv." + name

    def __enter__(self):
        # frame: [name, start ns, children's ns, record_function, events]
        frame = [self.name, 0, 0, None, None]
        if _recording():
            frame[3] = torch.profiler.record_function(self._tag)
            frame[3].__enter__()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                frame[4] = start
        try:
            _local.stack.append(frame)
        except AttributeError:
            _local.stack = [frame]
        frame[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        st = _local.stack
        name, t0, child, rf, start = st.pop()
        dt = t1 - t0
        parent = None
        if st:
            st[-1][2] += dt
            parent = st[-1][0]
        if rf is None:
            with _lock:
                _add(_spans[0], name, dt, dt - child, parent)
            return False
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        rf.__exit__(*exc)
        with _lock:
            for sec in _spans:
                _add(sec, name, dt, dt - child, parent)
            if start is not None:
                _pending.append((name, start, end))
                if len(_pending) > _PENDING_MAX:
                    _resolve(wait=False)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapped


def _resolve(wait: bool):
    """Add the device intervals of the pending events to their spans:
    all of them (``wait``: the table is being read), else those whose end
    event has completed.  Called with ``_lock`` held."""
    keep = []
    for item in _pending:
        name, start, end = item
        if not wait and not end.query():
            keep.append(item)
            continue
        end.synchronize()
        ms = start.elapsed_time(end)
        for sec in _spans:
            e = sec[name]
            e[3] = ms if e[3] is None else e[3] + ms
    _pending[:] = keep


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer: a shape, a size in bytes, a count) to the
    counter ``name``."""
    with _lock:
        c = _counts[0]
        c[name] = c.get(name, 0) + n
        if _recording():
            c = _counts[1]
            c[name] = c.get(name, 0) + n


def _crossing(t) -> None:
    count("sync.host")
    count("copy.bytes", t.numel() * t.element_size())


def sync(t):
    """``t``, about to be read on the host (``float``, ``.item()``,
    ``.tolist()``, ``.cpu()``): where it lies on a device, one wait of the
    host on the card (``sync.host``) and its bytes (``copy.bytes``) are
    counted."""
    if t.device.type != "cpu":
        _crossing(t)
    return t


def to(t, device=None, dtype=None):
    """``t.to(device, dtype)``, counting a copy between devices as a host
    wait (``sync.host``, ``copy.bytes``), and again in the backward, where
    the gradient crosses back."""
    device = t.device if device is None else torch.device(device)
    out = t.to(device, dtype)
    if device.type != t.device.type or (
            device.index is not None and device != t.device):
        _crossing(t)
        if out.requires_grad:
            out.register_hook(_crossing)
    return out


@contextlib.contextmanager
def recording():
    """Record as under torch's profiler (``record_function`` and device
    events, the profiled section) while the block runs."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def table(profiled: bool = False) -> dict:
    """{name: entry} of the whole run, or of what was added while the
    profiler recorded (``profiled``).  A span's entry: ``calls``,
    ``host_s``, ``self_s``, ``device_s`` (None without device events) and
    ``parents`` ({parent: calls}); a counter's: ``count``.  Resolves the
    pending device events first (waiting for them)."""
    with _lock:
        _resolve(wait=True)
        out = {name: {"calls": e[0], "host_s": e[1] * 1e-9,
                      "self_s": e[2] * 1e-9,
                      "device_s": None if e[3] is None else e[3] * 1e-3,
                      "parents": dict(e[4])}
               for name, e in _spans[profiled].items()}
        out.update({name: {"count": c}
                    for name, c in _counts[profiled].items()})
    return out


def reset() -> None:
    """Empty the table, both sections, and drop the pending events."""
    with _lock:
        for sec in _spans + _counts:
            sec.clear()
        _pending.clear()
