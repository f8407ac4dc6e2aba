"""The traced window's reduction: device operations from torch.profiler's
trace, the layers they belong to, the least time each layer could take,
and the breakdown for the ledger."""

from __future__ import annotations

import dataclasses
import importlib
import json
import re

from . import cell as cellmod

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class PlanShapes:
    """What the cost files read of a run's plan."""
    mf: object
    sz: int
    n_all: int
    dim: int
    n_rows: int
    width: int


@dataclasses.dataclass
class Step:
    """One priced pass of the window, as a kind's ``passes`` lists them
    and each layer's cost file reads them: a step may be several passes."""
    grad: bool
    general_ops: tuple | None      # (forward, backward) pair operations
    # solves through the pass's factor beyond the likelihood's own (a
    # posterior mean's back-substitution), for a cost file that prices them
    back_substitutions: int = 0


def load_events(path):
    """(device ops [(name, start us, end us)], host spans [(name, start,
    end)]) of a Chrome trace written by torch.profiler."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    ops, spans = [], []
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((name, ts, ts + dur))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], ts, ts + dur))
    ops.sort(key=lambda o: o[1])
    return ops, spans


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceContext:
    """What the metric readers read: the window's device operations with
    their layers, the steps, the spans, the layers' bounds and the whole
    step's operations."""

    def __init__(self, ops, spans, steps, bound_s, flops, peak_flops,
                 host_spans):
        step_spans = [s for s in spans if s[0] == "step"]
        self.steps = steps
        if step_spans:
            w0 = min(s[1] for s in step_spans)
            w1 = max(s[2] for s in step_spans)
            ops = [o for o in ops if o[2] > w0 and o[1] < w1]
            self.window_s = (w1 - w0) * 1e-6
        else:
            ops, w0, w1 = [], 0.0, 0.0
            self.window_s = 0.0
        pats = {k: [re.compile(p) for p in v]
                for k, v in cellmod.layer_patterns().items()}

        def layer_of(name):
            for layer, ps in pats.items():
                if any(p.search(name) for p in ps):
                    return layer
            return None

        self.ops = [(n, s, e, layer_of(n)) for n, s, e in ops]
        busy = _union([(max(s, w0), min(e, w1)) for _, s, e, _ in self.ops])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self._busy = busy
        self._w = (w0, w1)
        self.spans = dict(host_spans)
        self._host = [s for s in spans if s[0] != "step"] + step_spans
        self.bound_s = bound_s
        self.flops = flops
        self.peak_flops = peak_flops

    def device_s(self, layer):
        """Device seconds of the operations of ``layer`` (None: of those in
        no kernel layer)."""
        return sum(e - s for _, s, e, lay in self.ops if lay == layer) * 1e-6

    def breakdown(self, top=10):
        """{"device_ops": the operations that took most time, by name;
        "idle_gaps": the device's idle time within the window, by the
        benchmark's innermost host span at each gap}."""
        by_name = {}
        for n, s, e, _ in self.ops:
            key = n if len(n) <= 120 else n[:117] + "..."
            by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
        gaps = []
        w0, w1 = self._w
        prev = w0
        for s, e in self._busy + [[w1, w1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        by_span = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inner = [h for h in self._host if h[1] <= mid <= h[2]]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner \
                else "outside any step"
            by_span[name] = by_span.get(name, 0.0) + (g1 - g0) * 1e-6
        rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gap_rank = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in rank],
                "idle_gaps": [[k, v] for k, v in gap_rank]}


def layer_bounds(plan, steps, peaks, dtype_name):
    """({layer: least seconds of its launches over ``steps``}, total
    operations), by each layer's cost file (``costs/<layer>.py``)."""
    bw = float(peaks["hbm_bytes_per_s"])
    peak = float(peaks["flops_per_s"][dtype_name])
    bound, flops = {}, 0.0
    for layer in cellmod.layer_patterns():
        try:
            mod = importlib.import_module(f"portbench.costs.{layer}")
        except ModuleNotFoundError:
            continue
        t = 0.0
        for st in steps:
            for nbytes, ops in mod.step_cost(plan, st):
                t += max(nbytes / bw, ops / peak)
                flops += ops
        bound[layer] = t
    return bound, flops


def read_metric(name, ctx):
    spec = cellmod.metric_spec(name)
    mod = importlib.import_module(f"portbench.readers.{spec['reader']}")
    return mod.read(ctx, **spec.get("args", {}))
