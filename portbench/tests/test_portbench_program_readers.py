"""The readers of the program's own spans and counters
(``readers/program_span.py``, ``readers/program_counter.py``): a traced
run on the CPU at a small size reports the set-up phases as numbers and
the device intervals as nothing, every name a metric reads is one the
program writes, and a program without the table reads as nothing."""

from __future__ import annotations

import builtins
import types
from pathlib import Path

import pytest

import portbench.run as R
from portbench.lib import cell as cellmod
from portbench.readers import program_counter, program_span
from portbench.tests.helpers import bench, tiny_cell

PROGRAM = Path(R.ROOT) / "gpvecchia_torch"
READERS = ("program_span", "program_counter")
METRICS = [m for m in bench()["per_layer"]
           if cellmod.metric_spec(m["name"])["reader"] in READERS]
SETUP = ("plan_likelihood_s", "plan_mf_s", "plan_device_arrays_s")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """{traffic: (result line, the program's table after the run)}."""
    from gpvecchia_torch.utils import trace
    out = {}
    for traffic in ("mle", "loglik"):
        trace.reset()
        line = R.run_cell(tiny_cell(traffic), 2 ** 31 + 9, 0.5, 1, "cpu",
                          cache_dir=tmp_path_factory.mktemp(traffic),
                          log=lambda m: None)
        out[traffic] = (line, trace.table())
    trace.reset()
    return out


@pytest.mark.parametrize("traffic", ["mle", "loglik"])
def test_cpu_traced_run(traced, traffic):
    line, _ = traced[traffic]
    assert line["correct"] is True
    got = line["metrics"]
    for name in SETUP:
        assert got[name]["unit"] == "s" and got[name]["value"] > 0
    suffix = ".vg" if traffic == "mle" else ".eval"
    # no CUDA stream on the CPU: no device interval
    for name in ("u_entries_ms", "mf_forward_ms", "mf_top_levels_ms",
                 "mf_backward_ms"):
        assert name + suffix not in got
    # the CPU waits on no card and launches no kernel
    assert got["host_syncs_per_step" + suffix]["value"] == 0
    if traffic == "mle":
        assert got["h9_launches_per_step.vg"]["value"] == 0
    assert got["plan_s"]["value"] >= sum(got[n]["value"] for n in SETUP)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_reader_arguments_resolve(traced, m):
    """Each name a metric reads is one the program writes: a span the CPU
    run opened (of a depth range, the root's), a counter a string of the
    program's sources."""
    spec = cellmod.metric_spec(m["name"])
    args = spec["args"]
    if spec["reader"] == "program_counter":
        assert set(args) == {"counter"}
        assert any(f'"{args["counter"]}"' in f.read_text()
                   for f in PROGRAM.rglob("*.py"))
        return
    assert set(args) <= {"spans", "time", "per", "depths"}
    assert args["time"] in program_span.KEYS
    assert args["per"] in ("step", "run")
    assert (m["unit"] == "s") == (args["per"] == "run")
    assert (m["source"] == "device_trace") == (args["time"] == "device")
    traffic = "loglik" if m["name"].endswith(".eval") else "mle"
    _, tab = traced[traffic]
    depths = args.get("depths")
    if depths is not None:
        assert depths[0] <= depths[1]
        depths = [depths[0], depths[0]]
    # a value alone runs no backward
    names = [n for n in program_span.names(args["spans"], depths)
             if ".bwd" not in n or traffic == "mle"]
    assert names and all(n in tab for n in names)


def test_readers_on_a_table():
    """Per step in ms from the traced window's section, per run in s from
    the whole run's; a counter a step."""
    from gpvecchia_torch.utils import trace
    trace.reset()
    ctx = types.SimpleNamespace(steps=4)
    try:
        with trace.span("a"):
            trace.count("k", 3)
        with trace.recording():
            for _ in range(4):
                with trace.span("a"):
                    with trace.span("a.d0"):
                        trace.count("k", 2)
        prof = trace.table(profiled=True)
        whole = trace.table()
        assert program_span.read(ctx, ["a"], "host", "step") == \
            pytest.approx(prof["a"]["host_s"] / 4 * 1e3)
        assert program_span.read(ctx, ["a"], "self", "run") == \
            pytest.approx(whole["a"]["self_s"])
        assert program_span.read(ctx, ["a.d"], "host", "step",
                                 [0, 3]) == pytest.approx(
            prof["a.d0"]["host_s"] / 4 * 1e3)
        assert program_span.read(ctx, ["a"], "device", "step") is None
        assert program_span.read(ctx, ["none"], "host", "step") is None
        assert program_counter.read(ctx, "k") == 2
        assert program_counter.read(ctx, "never") == 0
    finally:
        trace.reset()


def test_program_without_a_table(monkeypatch):
    """On a program that keeps no trace table (an older checkout) each
    reader gives nothing and raises nothing."""
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "gpvecchia_torch.utils" and "trace" in (fromlist or ()):
            raise ImportError("no trace table")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    ctx = types.SimpleNamespace(steps=3)
    for m in METRICS:
        spec = cellmod.metric_spec(m["name"])
        reader = program_span if spec["reader"] == "program_span" \
            else program_counter
        assert reader.read(ctx, **spec["args"]) is None
