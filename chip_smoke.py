#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gpvecchia_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # n=1e5, m=20 (default)
    python3 chip_smoke.py --n 1000000 --m 40   # the north-star size, f32 only
    python3 chip_smoke.py --profile            # + a torch.profiler breakdown

Builds the host library and the CUDA kernels from this checkout, then

1. kernel phase: runs each of the four CUDA kernels (H1 matern_solve_e0,
   H2 leaf_assemble, H3 extend_add, H4 front_factor) on the card at the
   shapes of this run's plan, in float64 and float32, against its plain
   PyTorch version on the same inputs, and times both with CUDA events;
2. slice phase: drives ``vecchia_likelihood`` / ``loglik_fn`` on an SGV spec
   of bench.py's data (rng(1988) uniform locations, z ~ N(0, 1), covparms
   (1.0, 0.2, 0.5), nugget 0.1).  At the default size the f64 value on the
   card is held against the port's plain path on the CPU in f64, and the
   f32 value against the f64 one.  The launch counters of all four kernels
   are reset just before this phase and must be positive after it.

Every phase raises on failure (exit code != 0).  The last line of standard
output is one JSON object naming the device.  Without a CUDA device, or
without the gpvecchia_torch package beside it, the script exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel tolerances, kernel vs plain version on identical inputs.
#  * float64: relative 1e-9 of the largest reference entry.  Both sides are
#    backward-stable factorizations in another summation order; their gap
#    is ~eps64 * cond, and the conditioning matrices here have cond < 1e6.
#  * float32: the kernel's error against the float64 plain result may be at
#    most 4x the float32 plain version's own error against it, plus
#    1e-6 relative: a float32 kernel must be as accurate as float32 torch.
F64_REL_TOL = 1e-9
F32_FACTOR, F32_FLOOR = 4.0, 1e-6
# Slice tolerances: f64 card vs f64 CPU plain path (same algorithm, other
# summation orders), and f32 card vs f64 card (f32 rounding accumulated over
# ~1e5 log/quadratic terms; expected ~1e-5 relative).
SLICE_F64_REL = 1e-9
SLICE_F32_REL = 2e-4

COVPARMS = (1.0, 0.2, 0.5)
NUGGET = 0.1


def log(msg):
    print(msg, flush=True)


def cuda_time(fn, reps):
    """Median milliseconds of fn() over reps runs (CUDA events), warm."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(_once(fn, ()) for _ in range(reps))


class KernelCheck:
    """Kernel vs plain comparison at one shape, in f64 and f32."""

    def __init__(self, name):
        self.name = name
        self.rows = []

    def run(self, label, make_inputs, kernel, plain, out_of, mutates=False,
            main=True):
        """make_inputs(dtype) -> tuple of CUDA tensors; kernel/plain(*inputs)
        -> result; out_of(result) -> compared tensor.  ``mutates``: the call
        works in place, so every call gets freshly made inputs.  ``main``:
        the shape is the one the slice's main path gives the kernel."""
        ref = out_of(plain(*make_inputs(torch.float64))).double()
        scale = ref.abs().max().item()
        for dt in (torch.float64, torch.float32):
            k = out_of(kernel(*make_inputs(dt))).double()
            p = out_of(plain(*make_inputs(dt))).double()
            torch.cuda.synchronize()
            err = (k - p).abs().max().item()
            if dt == torch.float64:
                tol = F64_REL_TOL * scale
                ok = err <= tol
            else:
                err_k = (k - ref).abs().max().item()
                err_p = (p - ref).abs().max().item()
                tol = F32_FACTOR * err_p + F32_FLOOR * scale
                ok = err_k <= tol
            del k, p
            ok = ok and bool(np.isfinite(err))
            ms = self._time(kernel, make_inputs, dt, mutates)
            plain_ms = self._time(plain, make_inputs, dt, mutates)
            row = dict(shape=label, dtype=str(dt).split(".")[-1],
                       max_abs_err=err, tol=tol, scale=scale, ms=ms,
                       plain_ms=plain_ms, main=main)
            self.rows.append(row)
            log(f"  {self.name:16s} {label:34s} {row['dtype']}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e}, scale {scale:.3e}) "
                f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
            if not ok:
                raise AssertionError(f"{self.name} {label} {dt}: kernel "
                                     f"disagrees with its plain version")

    @staticmethod
    def _time(fn, make_inputs, dt, mutates, reps=3):
        if not mutates:
            args = make_inputs(dt)
            return cuda_time(lambda: fn(*args), reps)
        times = []
        for _ in range(reps + 1):
            args = make_inputs(dt)
            torch.cuda.synchronize()
            times.append(_once(fn, args))
            del args
        return statistics.median(times[1:])


def _once(fn, args):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def kernel_phase(spec, mf, seed, dev):
    from gpvecchia_torch.geometry.neighbors import find_ordered_nn
    from gpvecchia_torch.geometry.sgv import which_cond_on_latent
    from gpvecchia_torch.kernels import matern_solve as MS
    from gpvecchia_torch.linalg import frontal as FR

    rng = np.random.default_rng(seed)
    checks = {}

    # ---- H1 at F = 11, 21, 41 on this spec's points ----
    h1 = checks["matern_solve_e0"] = KernelCheck("matern_solve_e0")
    m = spec.m
    for F in (11, 21, 41):
        if F <= m + 1:
            NN = spec.NNarray[:, :F]
        else:
            NN = find_ordered_nn(spec.locsord, F - 1)
        cond = which_cond_on_latent(NN) & (NN >= 0)
        valid = NN >= 0
        n_all = spec.locsord.shape[0]
        nug = np.full(n_all, NUGGET)
        host = dict(NN=np.where(valid, NN, 0).astype(np.int32), valid=valid,
                    resp=valid & ~cond)

        def mk(dt, host=host, nug=nug):
            return (torch.as_tensor(spec.locsord, dtype=dt, device=dev),
                    torch.as_tensor(host["NN"], device=dev),
                    torch.as_tensor(host["valid"], device=dev),
                    torch.as_tensor(host["resp"], device=dev),
                    torch.as_tensor(nug, dtype=dt, device=dev),
                    torch.tensor(COVPARMS, dtype=torch.float64))

        h1.run(f"n={NN.shape[0]} F={F}", mk, MS.matern_solve_e0,
               MS.matern_solve_e0_plain, lambda x: x, main=F == m + 1)

    # ---- H2 + H4 at the leaf's shape ----
    leaf = mf.levels[-1]
    N, EL, K = leaf.elem_pos.shape
    P, B = leaf.npiv, leaf.nbord
    F1 = P + B + 1
    epos = leaf.elem_pos
    u = np.where(epos >= 0, rng.normal(size=epos.shape), 0.0)
    re = np.where(leaf.elem_pt >= 0, rng.normal(size=leaf.elem_pt.shape), 0.0)
    dv = np.zeros((N, F1))
    dv[:, :P] = np.where(leaf.piv_ids >= 0, 1.0 / NUGGET, 1.0)
    rv = np.zeros((N, F1))
    rv[:, :F1 - 1] = rng.normal(size=(N, F1 - 1))

    def mk_leaf(dt):
        return (torch.as_tensor(u, dtype=dt, device=dev),
                torch.as_tensor(epos, device=dev),
                torch.as_tensor(re, dtype=dt, device=dev),
                torch.as_tensor(dv, dtype=dt, device=dev),
                torch.as_tensor(rv, dtype=dt, device=dev))

    label = f"leaf N={N} EL={EL} K={K} F1={F1}"
    h2 = checks["leaf_assemble"] = KernelCheck("leaf_assemble")
    h2.run(label, mk_leaf, FR.leaf_assemble, FR.leaf_assemble_plain,
           torch.tril)

    h4 = checks["front_factor"] = KernelCheck("front_factor")
    fronts = {dt: FR.leaf_assemble_plain(*mk_leaf(dt))
              for dt in (torch.float64, torch.float32)}

    h4.run(label + f" P={P}", lambda dt: (fronts[dt].clone(), P),
           FR.front_factor, FR.front_factor_plain, torch.tril, mutates=True)

    # ---- H3 + H4 at the top internal level with the widest front ----
    d_top = max(range(mf.depth), key=lambda d: mf.levels[d].front,
                default=None)
    if d_top is not None:
        lv = mf.levels[d_top]
        N, P, B = lv.piv_ids.shape[0], lv.npiv, lv.nbord
        F1 = P + B + 1
        Bc1 = mf.levels[d_top + 1].nbord + 1
        ext = np.full((N, 2, F1), -1, np.int32)
        ext[:, :, :F1 - 1] = lv.ext
        ext[:, :, F1 - 1] = Bc1 - 1
        ch = rng.normal(size=(N, 2, Bc1, Bc1))
        ch = ch + np.swapaxes(ch, 2, 3)
        dv = np.zeros((N, F1))
        dv[:, :P] = 1.0
        rv = np.zeros((N, F1))
        rv[:, :F1 - 1] = rng.normal(size=(N, F1 - 1))

        def mk_top(dt):
            return (torch.as_tensor(ch, dtype=dt, device=dev),
                    torch.as_tensor(ext, device=dev),
                    torch.as_tensor(dv, dtype=dt, device=dev),
                    torch.as_tensor(rv, dtype=dt, device=dev))

        label = f"level {d_top} N={N} Bc1={Bc1} F1={F1}"
        h3 = checks["extend_add"] = KernelCheck("extend_add")
        h3.run(label, mk_top, FR.extend_add, FR.extend_add_plain,
               torch.tril)
        G = rng.normal(size=(N, F1, F1)) / np.sqrt(F1)
        spd = G @ np.swapaxes(G, 1, 2) + np.eye(F1)
        spd = 0.5 * (spd + np.swapaxes(spd, 1, 2))
        fronts_top = {dt: torch.as_tensor(spd, dtype=dt, device=dev)
                      for dt in (torch.float64, torch.float32)}

        h4.run(label + f" P={P}", lambda dt: (fronts_top[dt].clone(), P),
               FR.front_factor, FR.front_factor_plain, torch.tril,
               mutates=True, main=False)
    return checks


def profile_eval(spec, z):
    """One warm f32 evaluation under torch.profiler: device time by kernel
    and the device's busy share of the evaluation's wall time."""
    from torch.profiler import ProfilerActivity, profile

    import gpvecchia_torch as gt
    fn = gt.loglik_fn(spec, device="cuda", dtype=torch.float32)
    zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")
    float(fn(zt, COVPARMS, NUGGET))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(fn(zt, COVPARMS, NUGGET))
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=25))
    log(f"profile: eval wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f} %), "
        f"{len(spans)} device events")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1988)
    ap.add_argument("--profile", action="store_true",
                    help="profile one f32 evaluation (kernel time by name, "
                         "device busy share)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible")
    import gpvecchia_torch as gt
    from gpvecchia_torch.csrc import cuda, host
    from gpvecchia_torch.kernels import matern_solve as MS
    from gpvecchia_torch.linalg import frontal as FR
    from gpvecchia_torch.plan import get_mf_plan, get_plan
    if "jax" in sys.modules or "gpvecchia_tpu" in sys.modules:
        raise RuntimeError("the port imported jax or the JAX package")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    if not host.native_loaded():
        raise RuntimeError("native host library failed to build/load")
    log(f"hostops build: {time.perf_counter() - t0:.1f} s "
        f"({host.library_path().name})")
    t0 = time.perf_counter()
    cuda.get_lib()
    log(f"CUDA kernel library build: {time.perf_counter() - t0:.1f} s "
        f"({cuda.library_path().name})")
    for line in cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- host: spec + plan ----
    rng = np.random.default_rng(args.seed)
    locs = rng.uniform(size=(args.n, 2))
    z = rng.normal(size=args.n)
    t0 = time.perf_counter()
    spec = gt.vecchia_specify(locs, m=args.m, cond_yz="SGV")
    spec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = get_plan(spec)
    mf, _ = get_mf_plan(plan)
    plan_s = time.perf_counter() - t0
    log(f"host: spec {spec_s:.2f} s, plan {plan_s:.2f} s, MF depth "
        f"{mf.depth}, leaf {mf.levels[-1].elem_pos.shape}, root P "
        f"{mf.levels[0].npiv}")

    log("kernel phase (kernel vs plain version on the card):")
    checks = kernel_phase(spec, mf, args.seed, torch.device("cuda:0"))

    log("slice phase:")
    big = args.n > 100_000
    counters = (MS.matern_solve_e0, FR.leaf_assemble, FR.extend_add,
                FR.front_factor)
    for k in counters:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = {}
    for dt in ((torch.float32,) if big else (torch.float64, torch.float32)):
        t0 = time.perf_counter()
        ll = gt.vecchia_likelihood(z, spec, COVPARMS, NUGGET, device="cuda",
                                   dtype=dt)
        first_s = time.perf_counter() - t0
        fn = gt.loglik_fn(spec, device="cuda", dtype=dt)
        zt = torch.as_tensor(z, dtype=dt, device="cuda")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = float(fn(zt, COVPARMS, NUGGET))
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(ll) or abs(v - ll) > 1e-6 * abs(ll) + 1e-6:
            raise AssertionError(f"{dt}: loglik {ll} / {v} not finite or "
                                 "not repeatable")
        name = str(dt).split(".")[-1]
        res[name] = dict(loglik=ll, first_s=first_s,
                         eval_ms=statistics.median(times))
        log(f"  cuda {name}: loglik {ll!r}, first call {first_s:.2f} s, "
            f"median eval {res[name]['eval_ms']:.2f} ms over 5")
    launches = {k.__name__: k.launches for k in counters}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches during the slice phase: {launches}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")

    if not big:
        t0 = time.perf_counter()
        ll_cpu = gt.vecchia_likelihood(z, spec, COVPARMS, NUGGET,
                                       device="cpu", dtype=torch.float64)
        cpu_s = time.perf_counter() - t0
        ll64, ll32 = res["float64"]["loglik"], res["float32"]["loglik"]
        r64 = abs(ll64 - ll_cpu) / abs(ll_cpu)
        r32 = abs(ll32 - ll64) / abs(ll64)
        log(f"  cpu float64 plain path: loglik {ll_cpu!r} ({cpu_s:.1f} s)")
        log(f"  rel diff cuda f64 vs cpu f64: {r64:.3e} (tol "
            f"{SLICE_F64_REL:g})")
        log(f"  rel diff cuda f32 vs cuda f64: {r32:.3e} (tol "
            f"{SLICE_F32_REL:g})")
        if not (r64 <= SLICE_F64_REL and r32 <= SLICE_F32_REL):
            raise AssertionError("slice: the card disagrees with the "
                                 "reference path")

    if args.profile:
        profile_eval(spec, z)

    src = {"matern_solve_e0": "gpvecchia_torch/csrc/matern_solve.cu",
           "leaf_assemble": "gpvecchia_torch/csrc/frontal.cu",
           "extend_add": "gpvecchia_torch/csrc/frontal.cu",
           "front_factor": "gpvecchia_torch/csrc/frontal.cu"}
    replaces = {
        "matern_solve_e0": "gpvecchia_tpu/kernels/pallas_crout.py:268",
        "leaf_assemble": "gpvecchia_tpu/linalg/pallas_level.py:594",
        "extend_add": "gpvecchia_tpu/linalg/pallas_level.py:344",
        "front_factor": "gpvecchia_tpu/linalg/pallas_frontal.py:180"}
    kernels = []
    for name, chk in checks.items():
        # f32 (the production precision) at the main path's shape
        f32 = [r for r in chk.rows if r["dtype"] == "float32"]
        row = next((r for r in f32 if r["main"]), f32[0])
        kernels.append(dict(name=name, route="cuda", source=src[name],
                            replaces=replaces[name], launches=launches[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"]))
    print(json.dumps({"slice": res, "n": args.n, "m": args.m,
                      "spec_s": spec_s, "plan_s": plan_s,
                      "peak_bytes": peak, "smi": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
