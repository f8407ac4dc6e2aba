#!/usr/bin/env python3
"""The general Matern's H1 and H5 of two checkouts of the port on the same
rows, on one card: kernel ms and the outputs' bits.

    python3 scripts/torch_general_ab.py rows ROWS.npz [--n 1000000 --m 40]
    python3 scripts/torch_general_ab.py run ROOT ROWS.npz OUT.json
    python3 scripts/torch_general_ab.py compare A.json B.json

``rows`` builds an SGV and an MRA spec of n uniform points (rng 1988) with
this checkout and saves their plans' rows.  ``run`` imports the port from
the checkout at ROOT (one process a checkout; run them in turns, A B B A)
and launches the general H1 and H5 in float64 on both row sets at ranges
0.05 and 0.2, smoothness 0.8, nugget 0.1, H5 with a normal cotangent drawn
on the card from a fixed seed: it saves the median ms of 5 launches each,
SHA-256 digests of x and of H5's slot cotangents, and dpar beside OUT (and
the pair pass's counts where ROOT's port has them).  ``compare`` prints,
case by case, whether x and the slot cotangents are equal bit for bit,
dpar's largest relative difference per column, and both sides' ms.
"""

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

CASES = [(label, rho) for label in ("sgv", "mra") for rho in (0.05, 0.2)]


def rows(out, n, m):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import gpvecchia_torch as gt
    from gpvecchia_torch.plan import get_plan
    locs = np.random.default_rng(1988).uniform(size=(n, 2))
    arrays = {}
    for label, kw in (("sgv", dict(cond_yz="SGV")),
                      ("mra", dict(conditioning="mra"))):
        t0 = time.perf_counter()
        plan = get_plan(gt.vecchia_specify(locs, m=m, **kw))
        print(f"{label}: spec and plan {time.perf_counter() - t0:.1f} s, "
              f"rows {plan.NN.shape}", flush=True)
        arrays.update({f"{label}_locs": plan.locs, f"{label}_NN": plan.NN,
                       f"{label}_valid": plan.valid,
                       f"{label}_resp": plan.valid & ~plan.cond})
    np.savez(out, **arrays)


def _ms(fn, reps=5):
    import torch
    times = []
    for _ in range(reps + 1):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def _digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def run(root, rows_path, out):
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from gpvecchia_torch.kernels import matern_solve as MS
    if not Path(MS.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {MS.__file__}, not {root}'s port")
    dev = torch.device("cuda:0")
    z = np.load(rows_path)
    res = {}
    for label in ("sgv", "mra"):
        args = (torch.as_tensor(z[f"{label}_locs"], dtype=torch.float64,
                                device=dev),
                *(torch.as_tensor(z[f"{label}_{k}"], device=dev)
                  for k in ("NN", "valid", "resp")))
        nug = torch.full((args[0].shape[0],), 0.1, dtype=torch.float64,
                         device=dev)
        g = torch.Generator(device=dev).manual_seed(7)
        xbar = torch.randn(args[1].shape, generator=g, dtype=torch.float64,
                           device=dev)
        for rho in (0.05, 0.2):
            cp = torch.tensor((1.0, rho, 0.8), dtype=torch.float64)
            x = MS._launch(*args, nug, cp)
            dpar, dslot = MS._launch_bwd(*args, nug, cp, x, xbar)
            key = f"{label}_{rho}"
            case = dict(h1_ms=_ms(lambda: MS._launch(*args, nug, cp)),
                        h5_ms=_ms(lambda: MS._launch_bwd(*args, nug, cp, x,
                                                         xbar)),
                        x_sha256=_digest(x), dslot_sha256=_digest(dslot))
            np.save(Path(out).with_suffix(f".{key}.dpar.npy"),
                    dpar.cpu().numpy())
            if hasattr(MS, "STATS_FIELDS"):
                stats = torch.zeros(len(MS.STATS_FIELDS), dtype=torch.int64,
                                    device=dev)
                MS._launch(*args, nug, cp, stats=stats)
                case["stats"] = dict(zip(MS.STATS_FIELDS, stats.tolist()))
            res[key] = case
            print(key, {k: v for k, v in case.items()
                        if not k.endswith("sha256")}, flush=True)
    Path(out).write_text(json.dumps(res, indent=1))


def compare(a, b):
    A, B = (json.loads(Path(p).read_text()) for p in (a, b))
    for key in (f"{label}_{rho}" for label, rho in CASES):
        ca, cb = A[key], B[key]
        da, db = (np.load(Path(p).with_suffix(f".{key}.dpar.npy"))
                  for p in (a, b))
        ok = np.isfinite(da).all(1) & np.isfinite(db).all(1)
        rel = np.abs(da[ok] - db[ok]).max(0) / np.abs(da[ok]).max(0)
        print(f"{key}: x bit-equal {ca['x_sha256'] == cb['x_sha256']}, "
              f"slot cotangents bit-equal "
              f"{ca['dslot_sha256'] == cb['dslot_sha256']}, dpar largest "
              f"relative difference {rel.tolist()}; H1 {ca['h1_ms']:.2f} "
              f"vs {cb['h1_ms']:.2f} ms, H5 {ca['h5_ms']:.2f} vs "
              f"{cb['h5_ms']:.2f} ms")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("rows")
    r.add_argument("out")
    r.add_argument("--n", type=int, default=1_000_000)
    r.add_argument("--m", type=int, default=40)
    u = sub.add_parser("run")
    u.add_argument("root")
    u.add_argument("rows")
    u.add_argument("out")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "rows":
        rows(args.out, args.n, args.m)
    elif args.cmd == "run":
        run(args.root, args.rows, args.out)
    else:
        compare(args.a, args.b)


if __name__ == "__main__":
    main()
