#!/usr/bin/env python3
"""The f32 log-likelihood at a smooth smoothness and a long range, by the
PyTorch port (plain path on the CPU) and by the JAX package (on the CPU),
on the same SGV spec and data, with the rows each drops and the port's f64
value beside them.

    JAX_PLATFORMS=cpu python3 scripts/torch_f32_smooth_nu.py            # n=1e5, m=20
    JAX_PLATFORMS=cpu python3 scripts/torch_f32_smooth_nu.py --n 20000  # range scaled

Data as chip_smoke.py's: rng(1988) uniform locations in the unit square,
z ~ N(0, 1), nugget 0.1, covparms (1, range, nu) with range 0.05 at n=1e5
and 0.05 sqrt(1e5 / n) otherwise.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch
import jax.numpy as jnp

import gpvecchia_tpu as gj
from gpvecchia_tpu.inference.likelihood import loglik_fn as jax_loglik_fn

import gpvecchia_torch as gt
from gpvecchia_torch.convert import from_jax_spec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--nu", type=float, nargs="+", default=[1.4995, 2.0])
    args = ap.parse_args()
    rho = 0.05 * (1e5 / args.n) ** 0.5
    rng = np.random.default_rng(1988)
    locs = rng.uniform(size=(args.n, 2))
    z = rng.normal(size=args.n)
    jspec = gj.vecchia_specify(locs, m=args.m, cond_yz="SGV")
    tspec = from_jax_spec(jspec)
    for nu in args.nu:
        cp = (1.0, rho, nu)
        for name, dt in (("port f32", torch.float32), ("port f64", torch.float64)):
            t0 = time.perf_counter()
            fn = gt.loglik_fn(tspec, device="cpu", dtype=dt, with_aux=True)
            ll, aux = fn(torch.as_tensor(z, dtype=dt), cp, 0.1)
            print(f"n={args.n} m={args.m} range={rho:.4g} nu={nu} {name}: "
                  f"loglik {float(ll)!r}, rows dropped "
                  f"{int(aux['n_dropped_rows'])} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        fn = jax_loglik_fn(jspec, dtype=jnp.float32, with_aux=True)
        ll, aux = fn(np.asarray(z, np.float32), jnp.asarray(cp, jnp.float32),
                     jnp.asarray(0.1, jnp.float32))
        print(f"n={args.n} m={args.m} range={rho:.4g} nu={nu} jax f32: "
              f"loglik {float(ll)!r}, rows dropped "
              f"{int(aux['n_dropped_rows'])} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
