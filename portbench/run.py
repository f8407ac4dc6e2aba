"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``gpvecchia_torch`` and
``BENCHMARK.json``.  What a step does is the traffic's kind's
(``portbench/kinds/<entry>.py``): its inputs, its call into the port, its
points, its check and its priced passes.  Set-up (spec from its cache or
built, plan, device arrays, the cell's inputs from the seed, the warm-up
steps that build every kernel) is ``setup_s``; the window then runs the
traffic's steps back to back, one caller waiting for each answer, for
``--seconds``.  With ``--trace 1`` the window runs under torch.profiler
and the line carries the cell's per-layer metrics instead of its
end-to-end ones.  After the window the program's state is freed and the
kind's check holds a sample of the steps' answers against the plain
reference, which decides ``correct``.  The compared numbers and their
limits are the last lines on standard error and the ``checks`` key, last,
of the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"
# every compile cache a library might fill stays inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gpvecchia_tpu")
MAX_STEPS = 100_000


def forbidden_modules():
    """The loaded modules whose top-level name is a JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell, seed, seconds, trace, device, dtype=None,
             cache_dir=CACHE, t_start=T_START, log=print):
    """The result dict of one run of ``cell`` (``lib.cell.Cell``) on
    ``device``; ``dtype`` overrides the configuration's (the control)."""
    from portbench import reference
    from portbench.lib import cache, data, entries
    from portbench.lib import trace as tr

    cfg, traffic = cell.config, cell.traffic
    kind = entries.load_kind(traffic)
    dtype_name = dtype or cfg["dtype"]
    dt = entries.DTYPES[dtype_name]
    cuda = torch.device(device).type == "cuda"

    locs = data.locations(cfg)
    t = time.perf_counter()
    spec, built = cache.program_spec(
        cell, lambda: entries.build_spec(locs, cfg), cache_dir)
    spans = {"spec": time.perf_counter() - t}
    log(f"spec {'built' if built else 'loaded'} in {spans['spec']:.1f} s")
    inputs = kind.inputs(locs, traffic, seed, device)
    t = time.perf_counter()
    entry = kind.Entry(spec, inputs, traffic, dt, device)
    spans["plan"] = time.perf_counter() - t
    log(f"plan and device arrays in {spans['plan']:.1f} s")
    for p in kind.points(traffic, int(traffic["warmup_steps"])):
        entry(p)
    pts = kind.points(traffic, MAX_STEPS)

    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    outs, ends = [], []
    while len(outs) < MAX_STEPS:
        with torch.profiler.record_function("portbench.step"):
            outs.append(entry(pts[len(outs)]))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = ends[-1]
    steps_ms = np.diff([0.0] + ends) * 1e3
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {len(outs)} steps in {elapsed:.3f} s (a step: min "
        f"{steps_ms.min():.1f} ms, median {np.median(steps_ms):.1f}, max "
        f"{steps_ms.max():.1f}), set-up {setup_s:.1f} s, peak "
        f"{peak / 2 ** 30:.3f} GiB")

    result_metrics, device_info, breakdown = {}, {
        "platform": "gpu" if cuda else torch.device(device).type,
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}, None
    if trace:
        prof.__exit__(None, None, None)
        path = Path(cache_dir) / "trace" / f"{cell.name}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        del prof
        ops, host = tr.load_events(path)
        steps = kind.passes(spec, traffic, pts[:len(outs)], dt, device,
                            entry)
        peaks = json.loads((ROOT / "portbench/costs/peaks.json").read_text())
        bound_s, flops = tr.layer_bounds(_plan_shapes(spec, dt), steps,
                                         peaks, dtype_name)
        ctx = tr.TraceContext(ops, host, len(outs), bound_s, flops,
                              float(peaks["flops_per_s"][dtype_name]), spans)
        for m in cell.per_layer:
            v = tr.read_metric(m["name"], ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        breakdown = ctx.breakdown()
    else:
        e2e = {traffic["rate_metric"]: len(outs) / elapsed,
               "peak_device_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                result_metrics[m["name"]] = {"value": e2e[m["name"]],
                                             "unit": m["unit"]}

    # the program's state goes before the reference runs
    host = inputs.cpu().numpy()
    del entry, spec, inputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    arrays = cache.reference_arrays(
        cell, lambda: reference.build(locs, cfg, device), cache_dir)
    correct, checks, pick = kind.check(traffic, outs, pts, arrays, locs,
                                       host, data.rng(seed, 3), device)
    log(f"reference: steps {pick} in {time.perf_counter() - t:.1f} s")
    failed = sum(1 for v, g in outs if not math.isfinite(v)
                 or (g is not None and not all(map(math.isfinite, g))))
    out = {"correct": correct, "attempted": len(outs), "failed": failed,
           "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _plan_shapes(spec, dt):
    from portbench.lib import entries
    from portbench.lib.trace import PlanShapes
    mf, locs, NN = entries.plan_shapes(spec)
    return PlanShapes(mf=mf, sz=torch.empty((), dtype=dt).element_size(),
                      n_all=locs.shape[0], dim=locs.shape[1],
                      n_rows=NN.shape[0], width=NN.shape[1])


def _fmt(v):
    return None if isinstance(v, float) and not math.isfinite(v) else v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib.cell import Cell
    cell = Cell.find(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    out = run_cell(cell, args.seed, args.seconds, args.trace, "cuda",
                   log=log)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out["checks"] = {k: {kk: _fmt(vv) for kk, vv in c.items()}
                     for k, c in out["checks"].items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
