"""The port's trace table (``gpvecchia_torch.utils.trace``) on the CPU:
spans nest by thread and keep self time, autograd's backward opens them
too, the profiler's timeline holds them around the torch ops they ran and
the profiled section holds only what ran under the profiler, a likelihood's
value and gradient open each level of its multifrontal tree once in each
direction, and counters read no device value."""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gpvecchia_torch import loglik_fn, vecchia_specify
from gpvecchia_torch.plan import get_mf_plan, get_plan
from gpvecchia_torch.utils import trace


@pytest.fixture(autouse=True)
def empty_table():
    trace.reset()
    yield
    trace.reset()


def _busy(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_nesting_and_self_time():
    with trace.span("outer"):
        _busy(0.002)
        for _ in range(2):
            with trace.span("inner"):
                _busy(0.01)
    tab = trace.table()
    outer, inner = tab["outer"], tab["inner"]
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert inner["parents"] == {"outer": 2} and outer["parents"] == {}
    assert inner["host_s"] >= 0.02 and outer["host_s"] >= inner["host_s"]
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert 0.002 <= outer["self_s"] < 0.02
    assert inner["self_s"] == inner["host_s"]
    assert outer["device_s"] is None            # no device events on the CPU


def test_decorator_and_exception():
    @trace.span("fn")
    def fn(x):
        if x < 0:
            raise ValueError(x)
        return 2 * x

    assert fn(3) == 6 and fn.__name__ == "fn"
    with pytest.raises(ValueError):
        fn(-1)
    with trace.span("after"):
        pass
    tab = trace.table()
    assert tab["fn"]["calls"] == 2
    assert tab["after"]["parents"] == {}        # the raise closed its span


def test_threads_keep_their_own_stack():
    """A span opened on another thread has no parent on this one, and its
    time is no child time of this thread's open span."""
    def work():
        with trace.span("worker"):
            _busy(0.02)

    with trace.span("main"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    tab = trace.table()
    assert tab["worker"]["parents"] == {}
    assert tab["main"]["self_s"] == pytest.approx(tab["main"]["host_s"])


class _Square(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x

    @staticmethod
    @trace.span("square.bwd")
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 2.0 * x * g


def test_span_in_autograd_backward():
    """Autograd's engine opens the backward's span on the thread it runs
    the backward on; the span closes there and counts once a backward."""
    x = torch.arange(4.0, requires_grad=True)
    seen = []

    def grad_on_thread():
        y = _Square.apply(x).sum()
        seen.append(torch.autograd.grad(y, x)[0])

    grad_on_thread()
    th = threading.Thread(target=grad_on_thread)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    torch.testing.assert_close(seen[0], 2 * x.detach())
    torch.testing.assert_close(seen[1], 2 * x.detach())
    tab = trace.table()
    assert tab["square.bwd"]["calls"] == 2
    assert tab["square.bwd"]["parents"] == {}


def test_profiler_timeline_and_profiled_section(tmp_path):
    a = torch.randn(64, 64)
    with trace.span("before"):
        a @ a
    trace.count("hits", 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("inside"):
            with trace.span("inside.mm"):
                a @ a
            trace.count("hits")
    with trace.span("after"):
        a @ a
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X"]
    spans = {e["name"]: e for e in evs if e["name"].startswith("gpv.")}
    assert set(spans) == {"gpv.inside", "gpv.inside.mm"}
    mm = [e for e in evs if e["name"] == "aten::mm"]
    assert mm
    inner = spans["gpv.inside.mm"]
    assert any(inner["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= inner["ts"] + inner["dur"] for e in mm)
    outer = spans["gpv.inside"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= \
        outer["ts"] + outer["dur"]

    prof_tab = trace.table(profiled=True)
    assert set(prof_tab) == {"inside", "inside.mm", "hits"}
    assert prof_tab["hits"] == {"count": 1}
    whole = trace.table()
    assert {"before", "inside", "inside.mm", "after"} <= set(whole)
    assert whole["hits"] == {"count": 3}


def test_recording_without_the_profiler():
    with trace.recording():
        with trace.span("rec"):
            trace.count("c", 5)
    with trace.span("plain"):
        pass
    prof = trace.table(profiled=True)
    assert set(prof) == {"rec", "c"} and prof["c"]["count"] == 5
    assert "plain" in trace.table()


def _value_grad(n=600, m=6, seed=3):
    locs = np.random.default_rng(seed).uniform(size=(n, 2))
    spec = vecchia_specify(locs, m=m, cond_yz="SGV")
    z = np.random.default_rng(seed + 1).standard_normal(n)
    fn = loglik_fn(spec, device="cpu")
    c = torch.tensor([1.0, 0.2, 0.5], dtype=torch.float64, requires_grad=True)
    g = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    trace.reset()
    v = fn(z, c, g)
    dc, dg = torch.autograd.grad(v, (c, g))
    assert torch.isfinite(v) and torch.isfinite(dc).all()
    mf, _ = get_mf_plan(get_plan(spec))
    return mf.depth


def test_loglik_opens_each_level_once():
    depth = _value_grad()
    assert depth >= 2
    tab = trace.table()
    for k in range(depth + 1):
        for way in ("fwd", "bwd"):
            e = tab[f"mf.{way}.d{k}"]
            assert e["calls"] == 1 and e["parents"] == {f"mf.{way}": 1}
    assert not any(f"mf.{w}.d{depth + 1}" in tab for w in ("fwd", "bwd"))
    assert tab["mf.fwd"]["parents"] == {"loglik": 1}
    assert tab["u_entries"]["parents"] == {"loglik": 1}
    assert tab["u_entries.bwd"]["calls"] == 1
    assert tab["mf.bwd"]["calls"] == tab["loglik"]["calls"] == 1
    # the plain versions on the CPU: H9's plain version ran a level each,
    # no kernel launched, no host wait on a device
    assert tab["launches.front_factor_vjp"]["count"] == depth + 1
    assert not any(k.startswith("launches.") and k != "launches."
                   "front_factor_vjp" for k in tab)
    assert "sync.host" not in tab


class _Ops(TorchDispatchMode):
    """The tensor operations dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_counters_read_no_device_value():
    """Counting dispatches no tensor operation: shapes and dtypes only.  A
    meta tensor, which holds no values at all, counts as a device tensor
    read on the host."""
    meta = torch.empty(1000, 3, dtype=torch.float64, device="meta")
    cpu = torch.ones(7)
    with _Ops() as ops:
        trace.count("k", 4)
        assert trace.sync(meta) is meta
        assert trace.sync(cpu) is cpu
    assert ops.ops == []
    tab = trace.table()
    assert tab["k"] == {"count": 4}
    assert tab["sync.host"] == {"count": 1}
    assert tab["copy.bytes"] == {"count": 1000 * 3 * 8}


def test_copy_between_devices_counts_both_ways():
    """``trace.to`` counts a copy between devices, and once more where its
    gradient crosses back; a copy within a device is not counted."""
    x = torch.ones(5, dtype=torch.float64, requires_grad=True)
    y = trace.to(x, "cpu", torch.float32)           # same device
    assert y.dtype == torch.float32 and "sync.host" not in trace.table()
    m = trace.to(x, "meta")
    assert m.device.type == "meta"
    tab = trace.table()
    assert tab["sync.host"]["count"] == 1 and tab["copy.bytes"]["count"] == 40
    # the gradient crosses back in the backward: the hook ``to`` left on m
    # counts it when autograd calls it with the gradient
    hooks = list(m._backward_hooks.values())
    assert len(hooks) == 1
    hooks[0](torch.empty(5, dtype=torch.float64, device="meta"))
    tab = trace.table()
    assert tab["sync.host"]["count"] == 2 and tab["copy.bytes"]["count"] == 80
