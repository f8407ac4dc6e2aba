#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gpvecchia_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # n=1e5, m=20 (default)
    python3 chip_smoke.py --n 1000000 --m 40   # the north-star size, f32 only
    python3 chip_smoke.py --profile            # + torch.profiler breakdowns
    python3 chip_smoke.py --only-h4            # H4 alone; no final "ok" line
    python3 chip_smoke.py --only-h9            # H9 alone; no final "ok" line
    python3 chip_smoke.py --only-h15           # H1, H5 alone; no "ok" line
    python3 chip_smoke.py --only-assembly      # H2, H3 alone; no "ok" line

Builds the host library and the CUDA kernels from this checkout, then

1. kernel phase: runs each CUDA kernel on the card at the shapes of this
   run's plan, in float64 and float32, against its plain PyTorch version on
   the same inputs, and times both with CUDA events: the forward kernels
   H1 matern_solve_e0, H2 leaf_assemble (at the plan's leaf; two launches
   with the same bits), H8 solve_e0 (on
   the packed smoothness-0.8 covariances of the first row chunk), and the
   backward kernels H5 matern_solve_e0_bwd (against torch autograd through
   H1's plain version; both at F = 11, 21, 41, then at their edge shapes on
   both routes, their padding bit for bit and a batch with one matrix that
   is not SPD, ``h15_edge_phase``); H1 and H5 at the general smoothness 0.8
   (``matern_solve_e0[general]`` and ``matern_solve_e0_bwd[general]``, log
   K_nu inside the kernel: at the same F, float32 held on the rows whose
   float64 matrix has cond <= F32_COND_MAX, float64 on every row by its
   cond, H5 with the log-determinant's cotangent and d/dnu held to its own
   value, ``gen_run``; then at the edge shapes, at GEN_NUS on batches with
   pairs on both sides of s = 3, their padding and a matrix not SPD,
   ``gen_edge_phase``), solve_e0_bwd (K2 one to one,
   H8's backward: at H8's shape and on random SPD matrices) and H7
   leaf_assemble_bwd (reading the lower triangle of a cotangent whose
   upper triangle is NaN).  Then H2 and
   H3 at their edge shapes (``H2_EDGE_SHAPES``, ``H3_EDGE_SHAPES``: H3 bit
   for bit its plain version, H2 by the rule below, each launched twice
   with the same bits, upper triangles and guard values past the batch
   untouched, ``assembly_edge_phase``) and H3 at every internal level of
   this run's plan, bit for bit its plain version in both dtypes, with a
   row a level (ms, bound, share of bound) and the sums over the levels
   (``eadd_level_phase``; the widest level's row is H3's in the
   ``kernels`` line), and at each internal level H6 extend_add_bwd, bit
   for bit its plain version on the lower triangles it writes, through a
   strided view into child fronts' Schur blocks as on the main path, from
   a cotangent whose upper triangle is NaN.  Then H4
   front_factor, measured here only: the edge shapes of its blocked schedule (``H4_EDGE_SHAPES``, a batch whose
   middle front is not SPD, NaN in the strict upper triangle of the
   inputs), and H4 at every level of this run's multifrontal plan, each
   against its plain version (cuSOLVER potrf, cuBLAS trsm and gemm: the
   library's route), with the sum over the levels of an evaluation; the
   leaf's row is H4's in the ``kernels`` line.  Then H9 front_factor_bwd,
   H4's pullback in place: its edge shapes (``H9_EDGE_SHAPES``, NaN in the
   strict upper triangle of its inputs, which must not change a bit of
   the output) and H9 at every level of this run's plan against its plain
   version (``front_factor_vjp``, the JAX package's formula in torch and
   cuBLAS, and the store), with its CUDA launches a level and the sum over
   the levels of a value+grad; the leaf's row is H9's in the ``kernels``
   line;
2. slice phase: drives ``vecchia_likelihood`` / ``loglik_fn`` on an SGV spec
   of bench.py's data (rng(1988) uniform locations, z ~ N(0, 1), covparms
   (1.0, 0.2, 0.5), nugget 0.1).  At the default size the f64 value on the
   card is held against the port's plain path on the CPU in f64, and the
   f32 value against the f64 one; at n > 1e5 the f32 value is held against
   one f64 evaluation on the card.  The launch counters of H1-H4 are reset
   just before this phase and must be positive after it; the host time of
   the z-cache key of the numpy z is printed;
3. gradient phase: ``torch.autograd.grad`` of ``loglik_fn(...)(z, covparms,
   nuggets)`` in (covparms, nuggets), with a scalar nugget (timed: median
   of 5 value+grad evaluations) and once with a vector of nuggets.  At the
   default size the f64 gradient on the card is held against the CPU plain
   path in f64 and the f32 gradient against the f64 one.  All launch
   counters are reset just before this phase, and each of H1-H7 and H9
   must have launched in it; ``front_factor_vjp`` (H9's plain version)
   must not have run;
4. general-covariance phase: the same at covparms (1.0, 0.05, 0.8) (a
   smoothness without closed form: log K_nu is evaluated inside the general
   H1 and H5), value and value+grad (median of 5).  At the default size f64
   on the card is held against the CPU plain path in f64, f32 against f64,
   and the Matern at 0.5 passed as a user callable (H8's path) is held
   against the built-in 'matern' (H1's path).  All launch counters are
   reset just before the smoothness-0.8 runs and read just after them: the
   general H1 and H5 and the factor's kernels must launch in them, H8 and
   solve_e0_bwd must not.  The torch log K_nu layer (the plain build the
   general path ran before) is timed alone.  At covparms (1.0, 0.2, 0.8),
   the range users start at, where f32 drops rows: value and gradient
   finite, and the first row chunk's U entries in f32 held against f64 on
   the well-conditioned rows both keep.  The fused path is held against the
   packed path (the same Matern as a user callable: build_cov_packed, H8,
   solve_e0_bwd) in value and gradient, with the rows each drops in f32 at
   ranges 0.05 and 0.2, and in f32 at FVP_NUS, range 1/sqrt(n);
   ``esqe`` runs value+grad, and H8 and solve_e0_bwd
   must launch in it;
5. estimation phase: ``vecchia_estimate`` (L-BFGS-B, f32 on the card,
   max_iter 5, 3 at n=1e6) on this run's data plus a constant trend; at
   the default size also the same estimate to convergence in f32 and in
   f64 (theta_hat, iterations and dropped rows, reported), and a check at
   n=2000 on a dense GP draw in f64: the card's estimate must reach the
   CPU's log-likelihood to 1e-6 relative;
6. prediction phase: ``vecchia_prediction`` (posterior means and
   selected-inverse variances through the kept multifrontal factor) on the
   run's SGV spec (bench.py cfg2), and at the default size also on an SGV
   spec of the same points with PRED_N_PRED prediction points in the
   general ordering; the mean and the selected inverse timed apart
   (``pred_mean_ms``, ``pred_selinv_ms``: median of 5).  At the default
   size f64 on the card is held against the CPU plain path and f32 against
   f64; at n > 1e5 f32 against one f64 run on the card;
7. Vecchia-Laplace phase: ``calculate_posterior_VL``, logistic, on
   Bernoulli(0.5) data at the run's size in f32 (bench.py cfg4: ``vl_nr_ms``,
   ``vl_iters``, ``vl_iter_ms``, ``vl_cnvgd``, reported, never required)
   and once in f64 (reported), and f64 on the card against the CPU plain
   path on an SGV spec of the first VL_CHECK_N points.
   The launch counters of H1-H4 are reset just before each run of phases
   6 and 7 on a spec and must be positive after it;
8. MRA phase: ``vecchia_specify(conditioning="mra")`` at the run's n and m
   (bench.py cfg5) with its seconds split into the maxmin ordering, the
   native knot tree and the rest, the plan's shape (eff_m, depth, leaf F1,
   root P), ``mra_eval_ms`` (f32, median of 3, H1-H4 counted), value+grad
   in f32 (H1-H7 counted), rows dropped and peaks; f64 on the card against
   the CPU plain path and f32 against f64 (at n > 1e5 f32 against one f64
   run on the card); at the default size a 'firstm' spec alike;
9. selected phase (default size only): the selected (n, m+1) matrix of the
   MRA spec from ``hv.get_mat_cov`` held against the built-in Matern in
   value (f64, f32), nugget gradient (f64) and prediction mean; H8 and
   solve_e0_bwd must launch;
10. NUTS phase: bench.py cfg5b on the MRA spec (``nuts_transition_ms`` of
   the second transition with its value+grad count, H1-H7 counted), and at
   the default size ``fit.mcmc.sample_posterior`` (smoothness sampled: the
   general H1 and H5; f64) on the card and on the CPU from one seed, the
   draws held to NUTS_REL.
11. V-path phase: the per-entry V engine through the entry points
   (``vpath_phase``): the zy spec (vecchia_likelihood f64 and f32,
   loglik_fn evaluation and value+grad timed in f32, two value+grads bit
   for bit, zero nuggets on every V_ZERO_EVERY-th observation), the
   default spec with the PRED_N_PRED prediction points (zy, obspred:
   vecchia_prediction means, selected-inverse and exact prediction
   variances, each timed in f32; vecchia_pred once), SGV with them in the
   obspred ordering (the same), SGV IC0 (likelihood and value+grad as
   zy's, prediction) and a logistic VL solve on the zy spec; each spec's
   ensure_v seconds, v_nnz and level counts printed.  The launch counts
   are set to 0 before each case: H1 (and H5 after a value+grad) must
   launch, H2-H4 must not.  f32 is held against f64 on the card (values
   SLICE_F32_REL, predictions PRED_F32_REL, gradients V_GRAD_F32_REL of
   the joint |g|max), f64 against the CPU plain path on specs of the
   first V_SUB_N points and V_SUB_PRED prediction points, and H1/H5
   against their plain versions at the zy spec's latent rows, each
   conditioned on its own response at distance 0.  The f32 times are in
   the summary as zy_eval_ms, zy_vg_ms, zy_pred_mean_ms, ... .
12. mesh phase: the sharded path (``parallel/mesh.py``).  The run's SGV
   spec is written once with ``save_spec`` and every rank reads it with
   ``load_spec`` (both timed beside the spec's build); the kernels are
   built before, so the ranks load them.  ``run_local`` starts (a) one
   rank on NCCL and (b) two ranks on gloo, both on cuda:0 (NCCL refuses two
   ranks on one card; with four cards visible, (b) runs on two of them and
   (c) four NCCL ranks, one a card).  Each rank runs the sharded f32
   evaluation and value+grad (medians of 5), two value+grads bit for bit, the sharded
   posterior mean and variances, and at the default size the same in f64;
   it prints its leaves and elements, its sharded and replicated depths,
   the bytes exchanged and H1-H7's launches over one evaluation and one
   value+grad (each must launch), and its peak memory.  f32 is held to the
   single-process f64 value on the card (SLICE_F32_REL, posterior
   PRED_F32_REL), f64 to it at MESH_F64_REL (gradient MESH_GRAD_F64_REL of
   |g|max, posterior MESH_POST_F64_REL).  In (b) ``sample_posterior`` over
   a (chains=2, rows=1) mesh on phase 10's spec must give the draws of
   mesh=None.
   --n 1000000 --m 40 runs phases 2-4 and 6 in f32 only (6 holds f32
   against one f64 run on the card), phases 8 and 10 without their
   default-size parts, phase 11 on the zy and default prediction specs
   only, without the CPU check, and phase 12 in f32 only (its NUTS
   reference, mesh=None, run for it on the card).

The kernel phase also computes each kernel's bound (the least time the card
could take: the larger of the bytes its inputs and outputs need over the
HBM rate and its operations over the SIMT peak) and, where one PyTorch call
computes the same function (H1 and H8: ``torch.linalg.solve`` on the
conditioning matrices), that call's time.  No one call builds log K_nu and
solves, so the general H1 and H5 have none.

``--profile`` adds torch.profiler tables of one f32 evaluation, one
closed-form and one smoothness-0.8 value+grad, one prediction mean and
one selected inverse, and of the V path a zy and an IC0 value+grad, an
obspred prediction mean and its exact prediction variances (at n > 1e5
the zy value+grad and the default prediction spec's mean and exact
variances); a profile with H9 in it also splits H9's device time by part
(``h9_parts``).

``--only-mesh`` is a tool for work on the sharded path: it builds, makes
the spec of --n and --m and runs the mesh phase alone (its NUTS reference
then run for it), without the final device line.  ``--only-vpath`` is a
tool for work on the per-entry V engine: it builds,
holds two f32 value+grads of the run's SGV spec bit for bit, runs the
V-path phase (and with ``--profile`` its profiles) at ``--n``/``--m`` and
exits without the final device line.  ``--only-h4`` is a tool for work on
H4: it builds the kernels, runs the edge
shapes and the level phase on the fixed table of the 14 level shapes of
n=1e6, m=40 (no spec, no plan, no other phase) and exits without the final
device line, so that such a run is never taken for a pass.  ``--only-h9``
is the same for H9.  ``--only-h15``
is the same for H1 and H5: their edge shapes, then both at H15_FS on
H15_N Z-ordered points (``morton_points``), with the shared-memory route's
time beside the register route's.  ``--only-assembly`` is the same for H2
and H3: their edge shapes, then the spec and plan of --n and --m, H2 and
H7 at its leaf and H3 at each of its internal levels.

Every phase raises on failure (exit code != 0).  The last line of standard
output is one JSON object naming the device.  Without a CUDA device, or
without the gpvecchia_torch package beside it, the script exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
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
#  * float32 on the packed smoothness-0.8 covariances (H8, solve_e0_bwd):
#    many of these matrices are so ill-conditioned that float32 torch
#    itself is wrong by as much as the values, so the rule above would pass
#    anything there.  These kernels are held in float32 only on the rows
#    whose float64 matrix has a 2-norm condition number <= 1e5, and to at
#    most 1e-3 of those rows' largest entry.  On the CPU (first row chunk
#    at n=1e5/m=20 and all of n=2.6e4/m=40, ranges 0.05 and 0.2) float32
#    torch is within 1.0e-4 (H8) and 1.1e-4 (solve_e0_bwd) of that scale
#    on those rows, which are 85-100 % of them.
#  * the general Matern's H1 (log K_nu in the kernel): float32 on the rows
#    whose float64 matrix has cond <= F32_COND_MAX, by the 4x rule alone.
#    The cap fits H8, whose float32 input is the float64 matrix rounded;
#    the general H1 builds its matrix in float32, as its plain version
#    does, and on those rows the float32 build alone moves x by up to
#    4.4e-3 of their scale (on the CPU at n=1e5, m=20, F=11: 2.57e1 of
#    5.943e3 for torch's float32 build, 2.65e1 for the kernel's
#    arithmetic, 1.47 for the float64 matrix rounded).  float64 on every
#    row whose float64 matrix is positive definite, each row to
#    max(F64_REL_TOL, F64_COND_ULPS eps cond) of its own largest entry:
#    kernel and plain solve matrices built with ~10 ulps of log K_nu
#    rounding apart, so their x lie ~cond ulps apart; at n=1e6, m=40,
#    smoothness 0.8, range 0.05 a matrix of cond ~1e7 (x up to 1.6e7) gave
#    3.5e-2, 2.2e-9 of its scale, which is 1 x eps x cond.
F64_REL_TOL = 1e-9
F32_FACTOR, F32_FLOOR = 4.0, 1e-6
F64_COND_ULPS = 100
F32_COND_MAX, F32_CAP = 1e5, 1e-3
# Slice tolerances: f64 card vs f64 CPU plain path (same algorithm, other
# summation orders), and f32 card vs f64 card (f32 rounding accumulated over
# ~1e5 log/quadratic terms; expected ~1e-5 relative).
SLICE_F64_REL = 1e-9
SLICE_F32_REL = 2e-4
# Gradient tolerances, as max abs difference over a fixed scale.
#  * f64 card vs f64 CPU plain path: 1e-8 of the reference's largest entry
#    over (dcovparms, dnuggets); the same closed-form VJPs in other
#    summation orders (the CPU tests measure ~1e-15 against jax.grad).
#  * f32 card vs f64 card: 1e-4 of each group's own largest entry (dcovparms;
#    dnuggets).  On the CPU at n=2e4, m=20 f32 vs f64 measured <= 2.3e-6 by
#    that rule (the vector-nugget group), so this leaves a factor ~40 for the
#    card's summation orders and the larger n.
GRAD_F64_REL = 1e-8
GRAD_F32_REL = 1e-4
# General-covariance phase (smoothness 0.8):
#  * f64 card vs f64 CPU: value 1e-9 relative; gradient 1e-8 of |g|max in
#    (sig2, rho, nugget); d/dnu 1e-6 relative (a central difference over
#    2h = 6e-6 divides the log K_nu rounding of the two summation orders).
#  * f32 card vs f64 card: value 2e-4 relative; gradient per group: (sig2,
#    rho) 1e-3 of the pair's max, d/dnu 2e-2 relative, nuggets 1e-3 of
#    their max.  On the CPU at n=2e4, m=20, covparms (1.0, 0.2, 0.8), f32
#    vs f64 measured 1.1e-6 (value), 4.4e-5 (sig2, rho), 1.34e-3 (d/dnu:
#    f32 steps h = 1e-3 and f64 h = 3e-6, so the two central differences
#    differ by O(h^2) and f32 rounding over 2h) and 3.3e-5 (vector
#    nuggets), so these leave a factor 15-30 for the card's summation
#    orders and the larger n; at the range 0.05 used below the same
#    measurement gives 2.6e-7, 1.1e-5, 2.3e-4 and 7.2e-6.
#  * the nu = 0.5 callable (H8's path) vs the built-in 'matern' (H1's), f64:
#    1e-10 relative in value, 1e-10 of |g|max in (sig2, rho, nugget).
#  * the general H5 against its plain version: the cotangent of x is the
#    log-likelihood's log-determinant part, xbar = e0 / (2 x0) (the
#    derivative of log U_ii = log x0 / 2), on the rows whose float64
#    matrix has cond <= F32_COND_MAX (0 on the others, rows that float32
#    drops), so d/dnu sums one-signed terms over the points and is held to
#    its own value: GEN_DNU_F64_REL in float64, in float32 by the 4x rule
#    with GEN_F32_DNU of it as the least tolerance; (sig2, rho) and the
#    nuggets to F64_REL_TOL of their largest entry, and in float32 by the
#    4x rule with GEN_F32_PAIR and GEN_F32_NUG as the least.  On the CPU
#    (n=1001 Z-ordered points, the edge shapes and the smoothness list
#    below) the terms' magnitudes sum to 1-39 times the value; the float64
#    kernel's arithmetic of dg/dnu (its device code built for the host)
#    moved d/dnu by at most 6.6e-9 of it (2e-10 at smoothness 0.8), and
#    float32 torch's error was 1.4e-5 to 5.4e-2 of it (the most at nu = 3.7).
GEN_F64_REL, GEN_DNU_F64_REL = 1e-9, 1e-6
GEN_F32_PAIR, GEN_F32_DNU, GEN_F32_NUG = 1e-3, 2e-2, 1e-3
CROSS_REL = 1e-10
# Estimation: the card's L-BFGS-B estimate vs the CPU's, log-likelihood at
# the estimate, f64 (the same iterates up to gradient rounding).
EST_REL = 1e-6
# Prediction (posterior means and variances, each output -- mu_obs, mu_pred,
# var_obs, var_pred -- held as max |difference| over its own max |reference|):
#  * f64 card vs f64 CPU plain path: PRED_F64_REL (the same factor, solves
#    and selected inverse in other summation orders).
#  * f32 card vs f64 card: PRED_F32_REL.  On the CPU at n=2e4, m=20
#    (bench.py's data, SGV, without and with 2000 prediction points in the
#    general ordering) f32 vs f64 measured 2.5e-6 to 7.2e-6 by this rule,
#    so it leaves a factor ~30 for the card's summation orders and the
#    larger n.
PRED_F64_REL = 1e-9
PRED_F32_REL = 2e-4
PRED_N_PRED = 10_000     # prediction points of the default size's second spec
# Vecchia-Laplace (logistic, Bernoulli(0.5) data, bench.py cfg4): f64 card
# vs f64 CPU on an SGV spec of the first VL_CHECK_N points with m =
# VL_CHECK_M (the CPU's time bounded): the same iterations and convergence
# flag, the posterior mean and the pseudo-nuggets D to VL_F64_REL of their
# max |reference|.  Convergence is reported, never required.
VL_MAX_ITER = 30
VL_CHECK_N, VL_CHECK_M = 20_000, 20
VL_F64_REL = 1e-9
# NUTS (bench.py cfg5b at the run's MRA spec, then sample_posterior on the
# card and on the CPU plain path): the draws of the two runs, elementwise
# relative.  Both consume one CPU key stream, so they part only if a
# log-posterior's rounding (~1e-13 relative between the two in f64) moves
# an accept or a U-turn decision, or if the adaptation carries it (test
# side: ~1e-10 after 30 adaptive transitions on a 2-D Gaussian).
NUTS_REL = 1e-8
# cfg5b's step 0.05 diverges on its first step at theta0 = 0: the
# log-likelihood's gradient there grows with n, and half a step of 0.05
# moves the momentum by thousands.  A second transition takes the step
# NUTS_ND_STEP / |grad|max (a half step moves the momentum by at most
# 0.025), so it runs its whole trajectory, as bench.py's program always
# does (1 + 1 + 2 value+grads at max_depth 2 unless it turns).
NUTS_ND_STEP = 0.05
NUTS_N, NUTS_M = 5000, 10
NUTS_WARMUP, NUTS_SAMPLES, NUTS_CHAINS, NUTS_DEPTH, NUTS_SEED = 4, 2, 2, 3, 0

COVPARMS = (1.0, 0.2, 0.5)
# A smoothness without closed form.  The range is 0.05, not 0.2: at 0.2
# the smooth nu = 0.8 kernel makes some conditioning matrices numerically
# singular in float32 (on the CPU 1 row of n=1e5/m=20, and 48 of 2e5
# sampled rows of n=1e6/m=40; 0 and 2 of them at 0.05).  Such a row is
# dropped from the value in f32 and not in f64, so the f32-vs-f64 checks
# need a range where none drops.
GEN_COVPARMS = (1.0, 0.05, 0.8)
# The range users start at (the JAX package's default start takes the
# range from the data's spread, ~0.13 on the unit square): f32 drops rows
# there, and ``users_range_check`` holds what still can be held.  Its U
# entries in f32 vs f64, on the rows of the first chunk that both keep and
# whose f64 matrix has cond <= F32_COND_MAX, relative to their largest
# entry: on the CPU 2.3e-3 (n=1e5/m=20) and 9.0e-4 (n=2.6e4/m=40) at this
# range, 8.5e-4 and 6.2e-4 at range 0.05, so 1e-2 leaves a factor 4.
USER_COVPARMS = (1.0, 0.2, 0.8)
U_F32_REL = 1e-2
NUGGET = 0.1

# H100 SXM (NVIDIA data sheet): HBM3 rate, SIMT float32 and float64 peaks
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


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

    def run(self, label, make_inputs, kernel, plain, out_of, cost,
            mutates=False, main=True, library=None, f32_rows=None,
            dtypes=(torch.float64, torch.float32), rule=None,
            plain_reps=3, timed=True):
        """make_inputs(dtype) -> tuple of CUDA tensors; kernel/plain(*inputs)
        -> result; out_of(result) -> the compared tensor or tuple of tensors
        (each held to the rule with its own scale).  ``cost(dtype)`` ->
        (bytes, operations) the function needs at this shape: each input
        read once, each output written once, operations of what this run's
        data needs.  ``mutates``: the call works in place, so every call
        gets freshly made inputs.  ``main``: the shape is the one the
        slice's main path gives the kernel.  ``library(dtype)`` -> a
        no-argument call of one PyTorch function computing the same
        function on the same inputs (set up outside the timing), timed at
        the main shape only.  ``f32_rows``: a mask of the leading dimension;
        float32 is then held on those rows only, and to at most F32_CAP of
        their scale (see F32_COND_MAX).  ``dtypes``: the kernel's dtypes
        (the reference is the float64 plain version in any case).
        ``rule(part, k, p, r, dtype)`` -> (err, held, tol, scale, note):
        another rule than ``_rule`` for each compared part (None: ``_rule``
        with ``f32_rows``).  ``plain_reps``: timed runs of the plain
        version (1: one run, no warm-up: the check has run it).
        ``timed``: False for shapes that are checked only (no times)."""
        rule = rule or _rows_rule(f32_rows)
        ref = _parts(out_of(plain(*make_inputs(torch.float64))))
        for dt in dtypes:
            ks = _parts(out_of(kernel(*make_inputs(dt))))
            ps = ref if dt == torch.float64 and not mutates else _parts(
                out_of(plain(*make_inputs(dt))))
            torch.cuda.synchronize()
            ok, worst, ratios = True, None, []
            for part, (k, p, r) in enumerate(zip(ks, ps, ref)):
                err, held, tol, scale, note = rule(part, k, p, r, dt)
                good = held <= tol and bool(np.isfinite(err))
                ratio = held / tol if tol > 0 else float(held > 0)
                ratios.append(f"{ratio:.1e}")
                if worst is None or (ok and not good) or (
                        good == ok and ratio > worst[0]):
                    worst = (ratio, err, held, tol, scale, note, part)
                ok = ok and good
            del ks, ps
            _, err, held, tol, scale, rows, part = worst
            if len(ref) > 1:
                rows += (f" (part {part + 1}/{len(ref)}; each part's held/"
                         f"tol {', '.join(ratios)})")
            ms = plain_ms = float("nan")
            if timed:
                ms = self._time(kernel, make_inputs, dt, mutates)
                plain_ms = self._time(plain, make_inputs, dt, mutates,
                                      plain_reps)
            bound_ms, bound_by = _bound(*cost(dt), dt)
            library_ms = None
            if library is not None and main:
                library_ms = cuda_time(library(dt), 3)
                torch.cuda.empty_cache()
            row = dict(shape=label, dtype=str(dt).split(".")[-1],
                       max_abs_err=err, held_err=held, tol=tol, scale=scale,
                       ms=ms, plain_ms=plain_ms, main=main, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms)
            self.rows.append(row)
            lib = "" if library_ms is None else f"  library {library_ms:.3f} ms"
            vs = "plain" if dt == torch.float64 else "f64 plain"
            log(f"  {self.name:19s} {label:34s} {row['dtype']}: "
                f"max_abs_err {err:.3e}; vs {vs}{rows} {held:.3e} (tol "
                f"{tol:.3e}, scale {scale:.3e}) kernel {ms:.3f} ms  plain "
                f"{plain_ms:.3f} ms  bound {bound_ms:.3f} ms ({bound_by}){lib}")
            if not ok:
                raise AssertionError(f"{self.name} {label} {dt}: kernel "
                                     f"disagrees with its plain version")

    @staticmethod
    def _time(fn, make_inputs, dt, mutates, reps=3):
        if not mutates:
            args = make_inputs(dt)
            if reps == 1:                       # warm: the check ran it
                return _once(fn, args)
            return cuda_time(lambda: fn(*args), reps)
        times = []
        for _ in range(reps + 1):
            args = make_inputs(dt)
            torch.cuda.synchronize()
            times.append(_once(fn, args))
            del args
        return statistics.median(times[1:])


def _rule(k, p, r, scale, dt, capped=False, f64_tol=None, f32_floor=None):
    """(err, held, tol) of a kernel's result k against the plain version's p
    in the same dtype and the float64 plain reference r of largest entry
    ``scale`` (all as float64): err is |k - p|max; float64 holds it to
    F64_REL_TOL (or ``f64_tol``) of scale; float32 holds |k - r|max to
    F32_FACTOR times the float32 plain version's own error plus F32_FLOOR
    of scale (``capped``: to at most F32_CAP of scale; ``f32_floor``: to at
    least that share of scale)."""
    err = (k - p).abs().max().item()
    if dt == torch.float64:
        return err, err, (f64_tol or F64_REL_TOL) * scale
    tol = F32_FACTOR * (p - r).abs().max().item() + F32_FLOOR * scale
    if capped:
        tol = min(tol, F32_CAP * scale)
    if f32_floor:
        tol = max(tol, f32_floor * scale)
    return err, (k - r).abs().max().item(), tol


def _rows_rule(f32_rows):
    """KernelCheck's rule: ``_rule`` on every row, or in float32 on the
    rows of ``f32_rows`` to at most F32_CAP of their scale."""
    def rule(part, k, p, r, dt):
        note = ""
        if f32_rows is not None and dt == torch.float32:
            k, p, r = k[f32_rows], p[f32_rows], r[f32_rows]
            note = f" on {int(f32_rows.sum())}/{len(f32_rows)} rows"
        scale = r.abs().max().item()
        return _rule(k, p, r, scale, dt, capped=f32_rows is not None
                     and dt == torch.float32) + (scale, note)
    return rule


def _bound(nbytes, flops, dt):
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the HBM
    rate and the operations over the SIMT peak of ``dt``."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _chol_solve_ops(F, rhs=1):
    """Operations of one F x F Cholesky (F^3/3) and rhs pairs of triangular
    solves (2 F^2 each)."""
    return F ** 3 / 3 + 2 * F ** 2 * rhs


def cost_h4(dt, N, F1, P):
    """(bytes, operations) of H4 on N fronts: each front's lower triangle
    (H4 touches nothing else) read once and written once; the pivot block's
    Cholesky, the border solve and the Schur product's lower triangle."""
    B1 = F1 - P
    return N * F1 * (F1 + 1) * _size(dt), N * (P ** 3 / 3 + B1 * P * P
                                               + B1 * B1 * P)


def cost_h9(dt, N, F1, P, bw=64):
    """(bytes, operations) of H9 on N fronts, the blocked reverse sweep's:
    each front's lower triangle (the factor and the Schur cotangent in, the
    front's cotangent out) read once and written once; the Schur product's
    reverse 2 B1^2 P, and for each column block [j, k) of ``bw`` from the
    last the triangular solve of its F1 - k panel rows (kb^2 each), Xbar^T C
    (2 kb^2 (F1 - k)), the diagonal block's reverse (2/3 kb^3), and the
    panel products Rbar (2 j kb (F1 - j)) and Bbar (2 j (F1 - k) kb).  (The
    kernel's solve, a product with the block's inverse, does twice the
    solve's operations; the two-level order does the same products.)"""
    B1 = F1 - P
    ops = 2.0 * B1 * B1 * P
    for j in range(0, P, bw):
        k = min(P, j + bw)
        kb = k - j
        ops += (kb * kb * (F1 - k) + 2.0 * kb * kb * (F1 - k)
                + 2.0 * kb ** 3 / 3 + 2.0 * j * kb * (F1 - j)
                + 2.0 * j * (F1 - k) * kb)
    return N * F1 * (F1 + 1) * _size(dt), N * ops


def _size(dt):
    return torch.empty((), dtype=dt).element_size()


def _parts(result):
    parts = result if isinstance(result, tuple) else (result,)
    return tuple(t.double() for t in parts)


def _host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _once(fn, args):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _sym_randn(shape, seed, dev):
    """A float64 batch of symmetric normal matrices made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(shape, generator=g, dtype=torch.float64, device=dev)
    return 0.5 * (a + a.mT)


def h5_plain(locs, NN, valid, resp, nug, covparms, x, xbar, chunk=32768):
    """H5's reference: torch autograd through H1's plain version, in row
    chunks so the saved graph stays small (x is recomputed, not read)."""
    from gpvecchia_torch.kernels import matern_solve as MS
    c = covparms.clone().requires_grad_(True)
    ng = nug.clone().requires_grad_(True)
    dc, dn = torch.zeros_like(covparms), torch.zeros_like(nug)
    for s in range(0, NN.shape[0], chunk):
        sl = slice(s, s + chunk)
        xx = MS.matern_solve_e0_plain(locs, NN[sl], valid[sl], resp[sl], ng,
                                      c)
        a, b = torch.autograd.grad((xx * xbar[sl]).sum(), (c, ng))
        dc += a
        dn += b
    return dc, dn


def _first_chunk(spec, dev):
    """The first row chunk of the general path's plan on ``dev``: float64
    locations and nuggets, and the chunk's NN, valid and cond."""
    from gpvecchia_torch.kernels import u_entries as UE
    from gpvecchia_torch.plan import get_plan
    plan = get_plan(spec)
    rows = UE._row_chunks(plan.NN.shape[0], plan.NN.shape[1],
                          torch.float32)[0]
    out = {k: torch.as_tensor(getattr(plan, k)[rows], device=dev)
           for k in ("NN", "valid", "cond")}
    out["locs"] = torch.as_tensor(plan.locs, device=dev)
    out["nug"] = torch.full((plan.n_all,), NUGGET, dtype=torch.float64,
                            device=dev)
    return out


def _packed_cov(chunk, covparms):
    """The chunk's packed float64 Matern covariances (rows, P)."""
    from gpvecchia_torch.kernels import covariance as CV
    from gpvecchia_torch.kernels import u_entries as UE
    return UE.build_cov_packed(
        chunk["locs"], chunk["NN"], chunk["valid"], chunk["cond"],
        chunk["nug"], CV.matern,
        torch.tensor(covparms, dtype=torch.float64, device=chunk["locs"].device))


def _cond64(Cp64, F, step=16384):
    """2-norm condition numbers of packed float64 SPD matrices (inf where
    one is not positive definite)."""
    from gpvecchia_torch.kernels import matern_solve as MS
    out = []
    for s in range(0, Cp64.shape[0], step):
        ev = torch.linalg.eigvalsh(MS._unpack(Cp64[s:s + step], F), UPLO="L")
        out.append(torch.where(ev[:, 0] > 0, ev[:, -1] / ev[:, 0], torch.inf))
    return torch.cat(out)


def _library_solve(C):
    """A no-argument call of torch.linalg.solve(C, e0) on (n, F, F) C."""
    e0 = torch.zeros(C.shape[0], C.shape[1], 1, dtype=C.dtype,
                     device=C.device)
    e0[:, 0] = 1.0
    return lambda: torch.linalg.solve(C, e0)


def morton_points(n, F, seed):
    """n uniform points of the unit square in Z-order, each conditioned on
    the F - 1 points before it (slot 0 is the point itself): (locs, NN
    int32, valid, resp) with no neighbour search, so cheap at n = 1e6.
    resp, the slots that carry their nugget, is a seeded half of the valid
    ones."""
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    q = np.minimum(locs * 65536, 65535).astype(np.uint64)

    def spread(v):
        for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F),
                            (2, 0x33333333), (1, 0x55555555)):
            v = (v | (v << np.uint64(shift))) & np.uint64(mask)
        return v

    locs = locs[np.argsort(spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)),
                           kind="stable")]
    NN = np.arange(n)[:, None] - np.arange(F)[None, :]
    valid = NN >= 0
    resp = valid & (rng.random(size=(n, F)) < 0.5)
    return locs, np.where(valid, NN, 0).astype(np.int32), valid, resp


def _h15_inputs(locs, NN, valid, resp, nug, dev, covparms=COVPARMS):
    """make_inputs(dtype) of H1 for host arrays."""
    def mk(dt):
        return (torch.as_tensor(locs, dtype=dt, device=dev),
                torch.as_tensor(NN, device=dev),
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(resp, device=dev),
                torch.as_tensor(nug, dtype=dt, device=dev),
                torch.tensor(covparms, dtype=torch.float64))
    return mk


@contextlib.contextmanager
def shared_route(dt):
    """Every F on H1 and H5's shared-memory route in ``dt`` (the route every
    F took before the register route existed) inside the block."""
    from gpvecchia_torch.kernels import matern_solve as MS
    saved = MS.REGS_MAX_F[dt]
    MS.REGS_MAX_F[dt] = 0
    try:
        yield
    finally:
        MS.REGS_MAX_F[dt] = saved


def h15_run(h1, h5, locs, NN, valid, resp, label, main, seed, dev,
            dtypes=(torch.float64, torch.float32), against_shared=False):
    """H1 and H5 against their plain versions (H5's: torch autograd through
    H1's) on one batch of host arrays, with the bound, and for H1 at the
    main shape the time of ``torch.linalg.solve`` on the built matrices.
    ``against_shared``: where F takes the register route, also time both
    kernels on the shared-memory route (the route every F took before the
    register route existed) on the same inputs, as ``shared_ms`` of the
    rows."""
    from gpvecchia_torch.kernels import matern_solve as MS
    n_all, d = locs.shape
    n, F = NN.shape
    mk = _h15_inputs(locs, NN, valid, resp, np.full(n_all, NUGGET), dev)

    def cost_h1(dt, extra=0):
        # locs, nug_point, NN, valid, resp in; x out (+ extra bytes); the
        # covariance build takes ~12 operations a pair
        sz = _size(dt)
        return (n_all * (d + 1) * sz + n * F * (4 + 2) + n * F * sz + extra,
                n * (_chol_solve_ops(F) + 12 * F * (F + 1) / 2))

    def lib_h1(dt):
        locs_t, NNt, v, r, ng, cp = mk(dt)
        C = torch.empty(n, F, F, dtype=dt, device=dev)
        for s0 in range(0, n, 65536):
            sl = slice(s0, s0 + 65536)
            C[sl] = MS._cov_chunk(locs_t, NNt[sl].long(), v[sl], r[sl], ng,
                                  cp.to(dev, dt))[0]
        return _library_solve(C)

    h1.run(label, mk, MS.matern_solve_e0, MS.matern_solve_e0_plain,
           lambda x: x, cost_h1, main=main, library=lib_h1, dtypes=dtypes)

    xbar = np.random.default_rng(seed).normal(size=(n, F))
    bwd_in = {}

    def mk_bwd(dt):
        if dt not in bwd_in:
            args = mk(dt)
            x = MS.matern_solve_e0_plain(*args)
            bwd_in[dt] = args + (x, torch.as_tensor(xbar, dtype=dt,
                                                    device=dev))
        return bwd_in[dt]

    def cost_h5(dt):
        # H1's inputs plus x and xbar in, dpar (n, 2) f64 and dslot out;
        # ~20 operations a pair for the rebuild and the contraction
        nbytes, _ = cost_h1(dt, extra=2 * n * F * _size(dt) + 16 * n)
        return nbytes, n * (_chol_solve_ops(F) + 20 * F * (F + 1) / 2)

    h5.run(label, mk_bwd, MS.matern_solve_e0_bwd, h5_plain,
           lambda r: (r[0][:2], r[1]), cost_h5, main=main, dtypes=dtypes)
    if not against_shared:
        return
    for dt in dtypes:
        if MS.route(F, dt) != "registers":
            continue
        args, bargs = mk(dt), mk_bwd(dt)
        with shared_route(dt):
            t1 = cuda_time(lambda: MS.matern_solve_e0(*args), 3)
            t5 = cuda_time(lambda: MS.matern_solve_e0_bwd(*bargs), 3)
        name = str(dt).split(".")[-1]
        for chk, t in ((h1, t1), (h5, t5)):
            row = next(r for r in chk.rows
                       if r["shape"] == label and r["dtype"] == name)
            row["shared_ms"] = t
            log(f"  {chk.name:19s} {label:34s} {name}: register route "
                f"{row['ms']:.3f} ms, shared-memory route {t:.3f} ms")


# Operations of the general Matern's kernels, for their bound.  One log
# K_nu: ~40 of set-up (each transcendental, log, exp, sinh, counted as one)
# and then on Temme's branch (x <= 3) 14 a term, at the terms the kernel's
# exit rule takes at this run's x, or on CF2's branch (x > 3) ~20 a step,
# at the steps this run's x takes (both counted by kernels/bessel.py's
# ``_temme_kmu`` and ``_cf2_kmu``).  A pair of the forward adds ~10
# (distance, log s, exp); the backward evaluates log K at nu (with the
# climb's next ratio), nu + h and |nu - h| and adds ~30 a pair.
OPS_LOGK_SETUP, OPS_TEMME_TERM, OPS_CF2_STEP = 40, 14, 20
OPS_PAIR_FWD, OPS_PAIR_BWD = 10, 30


def _gen_ops(args, covparms, dt, step=65536):
    """(forward, backward) operations of the general Matern's pairs on
    these inputs (float64 tensors on the card) in ``dt``, by the counts
    above.  Temme's terms grow with x: they are counted on a grid of x <=
    3 and read at the grid point at or above each pair's x."""
    from gpvecchia_torch.kernels import bessel
    from gpvecchia_torch.kernels import matern_solve as MS
    locs, NN, valid = args[:3]
    F = NN.shape[1]
    w = MS.general_params(covparms[2], dt)
    mus = [torch.tensor(w[e * MS.KV_WORDS], dtype=dt, device=locs.device)
           for e in range(3)]
    grid = torch.linspace(0.0, 3.0, 3001, dtype=dt, device=locs.device)[1:]
    terms = [bessel._temme_kmu(mu, grid, terms=True)[2] for mu in mus]
    il, jl = torch.tril_indices(F, F, -1, device=locs.device)
    ops = [0.0] * 3
    pairs = 0
    for s0 in range(0, NN.shape[0], step):
        nn, v = NN[s0:s0 + step].long(), valid[s0:s0 + step]
        pts = locs[nn]
        dist = (pts[:, il] - pts[:, jl]).norm(dim=-1)
        x = (dist[v[:, il] & v[:, jl] & (dist > 0)] / covparms[1]).to(dt)
        pairs += x.numel()
        at = torch.bucketize(x[x <= 3.0], grid).clamp(max=len(grid) - 1)
        big = x[x > 3.0]
        for e, mu in enumerate(mus):
            ops[e] += x.numel() * OPS_LOGK_SETUP + OPS_TEMME_TERM * float(
                terms[e][at].sum()) + OPS_CF2_STEP * float(
                    bessel._cf2_kmu(mu, big, steps=True)[2].sum())
    return (ops[0] + pairs * OPS_PAIR_FWD,
            sum(ops) + pairs * OPS_PAIR_BWD)


def _conds(args, step=16384):
    """2-norm condition numbers of the points' float64 conditioning
    matrices (H1's plain build; inf where one is not positive definite)."""
    from gpvecchia_torch.kernels import matern_solve as MS
    locs, NN, valid, resp, nug, cp = args
    cp = cp.to(locs.device)
    out = []
    for s0 in range(0, NN.shape[0], step):
        sl = slice(s0, s0 + step)
        C = MS._cov_chunk(locs, NN[sl].long(), valid[sl], resp[sl], nug,
                          cp)[0]
        ev = torch.linalg.eigvalsh(C)
        out.append(torch.where(ev[:, 0] > 0, ev[:, -1] / ev[:, 0], torch.inf))
    return torch.cat(out)


def _cond_rule(cond):
    """KernelCheck rule of the general H1 (see F64_COND_ULPS): float32 on
    the rows with cond <= F32_COND_MAX by the 4x rule alone; float64 on
    every row whose float64 matrix is positive definite, each to
    max(F64_REL_TOL, F64_COND_ULPS eps cond) of its own largest entry
    (``held`` is the largest ratio of a row's error to its tolerance, held
    to 1)."""
    well = cond <= F32_COND_MAX
    pd = torch.isfinite(cond)
    rel = torch.clamp(F64_COND_ULPS * torch.finfo(torch.float64).eps
                      * cond[pd], min=F64_REL_TOL)
    n_wide = int((rel > F64_REL_TOL).sum())
    top = float(cond[pd].max()) if bool(pd.any()) else 0.0

    def rule(part, k, p, r, dt):
        if dt == torch.float32:
            k, p, r = k[well], p[well], r[well]
            scale = r.abs().max().item()
            return _rule(k, p, r, scale, dt) + (
                scale, f" on {int(well.sum())}/{len(well)} rows")
        k, p, r = k[pd], p[pd], r[pd]
        row_err = (k - p).abs().amax(1)
        ratio = (row_err / (rel * r.abs().amax(1))).max().item()
        return (row_err.max().item(), ratio, 1.0, r.abs().max().item(),
                f" on {int(pd.sum())}/{len(pd)} rows, each by its cond "
                f"({n_wide} above {F64_REL_TOL:g}, max cond {top:.2e})")
    return rule


def _bwd_rule(part, k, p, r, dt):
    """KernelCheck rule of the general H5, parts (sig2, rho), d/dnu and the
    nuggets (see GEN_DNU_F64_REL)."""
    scale = r.abs().max().item()
    return _rule(k, p, r, scale, dt, f64_tol=(None, GEN_DNU_F64_REL,
                                              None)[part],
                 f32_floor=(GEN_F32_PAIR, GEN_F32_DNU, GEN_F32_NUG)[part]) \
        + (scale, "")


def gen_run(h1g, h5g, locs, NN, valid, resp, covparms, label, main, dev,
            dtypes=(torch.float64, torch.float32), plain_reps=3,
            timed=True):
    """The general Matern's H1 and H5 (``matern_solve_e0[general]``,
    ``matern_solve_e0_bwd[general]``) against their plain versions (the
    backward's: ``matern_solve_e0_bwd_plain`` reduced as the wrapper
    reduces) on one batch of host arrays at ``covparms``, with their bound:
    H1 by ``_cond_rule``, H5 by ``_bwd_rule`` with the log-determinant's
    cotangent of x on the rows with cond <= F32_COND_MAX."""
    from gpvecchia_torch.kernels import matern_solve as MS
    n_all, d = locs.shape
    n, F = NN.shape
    mk = _h15_inputs(locs, NN, valid, resp, np.full(n_all, NUGGET), dev,
                     covparms)
    args64 = mk(torch.float64)
    cond = _conds(args64)
    ops = {dt: _gen_ops(args64, covparms, dt) for dt in dtypes}

    def cost_fwd(dt):
        sz = _size(dt)
        return (n_all * (d + 1) * sz + n * F * (4 + 2) + n * F * sz,
                n * _chol_solve_ops(F) + ops[dt][0])

    h1g.run(label, mk, MS.matern_solve_e0, MS.matern_solve_e0_plain,
            lambda x: x, cost_fwd, main=main, dtypes=dtypes,
            rule=_cond_rule(cond), plain_reps=plain_reps, timed=timed)

    # xbar = d(log x0 / 2)/dx on the well-conditioned rows
    x0 = MS.matern_solve_e0_plain(*args64)[:, 0]
    xbar = torch.zeros(n, F, dtype=torch.float64, device=dev)
    xbar[:, 0] = torch.where(cond <= F32_COND_MAX, 0.5 / x0, 0.0)
    del args64, x0
    bwd_in = {}

    def mk_bwd(dt):
        if dt not in bwd_in:
            a = mk(dt)
            bwd_in[dt] = a + (MS.matern_solve_e0_plain(*a), xbar.to(dt))
        return bwd_in[dt]

    def plain_bwd(locs_t, NN_t, v, r, nug, cp, x, xb):
        return MS.reduce_bwd(*MS.matern_solve_e0_bwd_plain(
            locs_t, NN_t, v, r, nug, cp, x, xb), xb, NN_t, r, nug, cp)

    def cost_bwd(dt):
        # H1's inputs plus x and xbar in, dpar (n, 3) f64 and dslot out; the
        # factor, the solve and ~6 operations a pair of contraction
        nbytes, _ = cost_fwd(dt)
        return (nbytes + 2 * n * F * _size(dt) + 24 * n,
                n * (_chol_solve_ops(F) + 6 * F * (F + 1) / 2) + ops[dt][1])

    h5g.run(label, mk_bwd, MS.matern_solve_e0_bwd, plain_bwd,
            lambda r: (r[0][:2], r[0][2:], r[1]), cost_bwd, main=main,
            dtypes=dtypes, rule=_bwd_rule, plain_reps=plain_reps,
            timed=timed)


def _edge_fs():
    """The F at which H1 and H5 are checked beyond the main path's: small
    F, a warp's width, the instantiated sizes around 8, each route's
    largest F and one on either side of the route boundary, with the dtypes
    that take each (H1 and H5 refuse F above ``max_neighbors``)."""
    from gpvecchia_torch.kernels import matern_solve as MS
    out = {}
    for dt in (torch.float64, torch.float32):
        top = MS.max_neighbors(2, dt)
        edge = MS.REGS_MAX_F[dt]
        for F in sorted({1, 2, 7, 8, 9, 31, 32, 33, edge - 1, edge, edge + 1,
                         top}):
            if F <= top:
                out.setdefault(F, []).append(dt)
    return sorted(out.items())


def h15_edge_phase(dev, seed, n=1001):
    """H1 and H5 at their edge shapes on n Z-ordered points (n not a
    multiple of the points a block) in both routes and dtypes, by
    KernelCheck's rule.  Then: the register route's padding, a kernel call
    at F against one at the next instantiated size with the extra slots
    invalid, bit for bit, with 0 in the padded slots; and a batch in which
    one point's conditioning matrix is not positive definite: NaN or Inf
    in that point's row only, every other row held to the plain version."""
    from gpvecchia_torch.kernels import matern_solve as MS
    h1 = KernelCheck("matern_solve_e0 edge")
    h5 = KernelCheck("matern_solve_e0_bwd edge")
    for F, dtypes in _edge_fs():
        locs, NN, valid, resp = morton_points(n, F, seed + F)
        h15_run(h1, h5, locs, NN, valid, resp, f"n={n} F={F} ({MS.route(F, dtypes[-1])})",
                False, seed + F, dev, dtypes=tuple(dtypes))

    padding_check(dev, seed, n, COVPARMS, "H1/H5")
    non_spd_check(dev, seed, n, COVPARMS, "H1/H5")


# The general Matern's kernels beyond the main path's shape: smoothness
# 0.3 (k = 0), 0.8, 2.0 (mu = 0: the small-mu guards), 1.4995, within
# 1e-3 of 1.5 (in float32 nu + h rounds to k = 2, nu and |nu - h| to k = 1),
# and 3.7 (k = 4: the climb's longest here; at the default seed 22 and 217
# of the F = 21 and F = 72 batches' matrices have cond > F32_COND_MAX,
# which float32 drops),
# at a range at which the Z-ordered points' pairs lie on both sides of
# s = 3 (Temme's series and CF2)
GEN_NUS = (0.3, 0.8, 2.0, 1.4995, 3.7)
GEN_EDGE_RANGE = 0.02
GEN_SUB_N = 100_000


def gen_edge_phase(dev, seed, n=1001):
    """The general Matern's H1 and H5 at the edge shapes of both routes
    (smoothness 0.8, range 0.05), at GEN_NUS on a batch of each route with
    pairs on both sides of s = 3, their padding bit for bit and a batch
    with one matrix not SPD, by KernelCheck's rule (not timed)."""
    from gpvecchia_torch.kernels import matern_solve as MS
    h1g = KernelCheck("matern_solve_e0[general] edge")
    h5g = KernelCheck("matern_solve_e0_bwd[general] edge")
    for F, dtypes in _edge_fs():
        locs, NN, valid, resp = morton_points(n, F, seed + F)
        gen_run(h1g, h5g, locs, NN, valid, resp, GEN_COVPARMS,
                f"n={n} F={F} ({MS.route(F, dtypes[-1])})", False, dev,
                dtypes=tuple(dtypes), timed=False)
    for F in (21, 72):
        locs, NN, valid, resp = morton_points(n, F, seed + F)
        pts = locs[NN]
        ok = valid[:, :, None] & valid[:, None, :]
        x = np.linalg.norm(pts[:, :, None] - pts[:, None, :], axis=-1)[ok] \
            / GEN_EDGE_RANGE
        n_cf2, n_temme = int((x > 3).sum()), int(((x > 0) & (x <= 3)).sum())
        if not (n_cf2 and n_temme):
            raise AssertionError("the batch has no pairs on one side of s=3")
        for nu in GEN_NUS:
            gen_run(h1g, h5g, locs, NN, valid, resp,
                    (1.0, GEN_EDGE_RANGE, nu),
                    f"n={n} F={F} nu={nu} ({MS.route(F, torch.float32)})",
                    False, dev, timed=False)
        log(f"  general H1/H5 F={F}: {n_temme} pairs at s <= 3, {n_cf2} at "
            f"s > 3, smoothness {GEN_NUS} held")
    padding_check(dev, seed, n, GEN_COVPARMS, "general H1/H5")
    non_spd_check(dev, seed, n, GEN_COVPARMS, "general H1/H5")


# The general instances' pair list on the shared-memory route (csrc/
# matern_solve.cu ``build_pair_list``) at F = 33, 41 and each dtype's
# largest F (float32's smaller F forced onto the shared route): batches
# whose pairs all lie at s <= 3, all above it, or on both sides (the range
# a third of the median pair distance, so nearly every chunk of the column
# walk held both), the last also with GEN_LIST_DROP of the slots invalid
GEN_LIST_FS = (33, 41)
GEN_LIST_DROP = 0.3


def _pair_dists(locs, NN, valid):
    """Distances of the points' valid off-diagonal pairs at distance > 0:
    the pairs the general instances list."""
    il, jl = np.tril_indices(NN.shape[1], -1)
    pts = locs[NN]
    dist = np.linalg.norm(pts[:, il] - pts[:, jl], axis=-1)
    return dist[valid[:, il] & valid[:, jl] & (dist > 0)]


def gen_counts(launch, dev):
    """The engagement counts (``MS.STATS_FIELDS``) that ``launch(stats)``,
    one call of a general instance on the shared-memory route, adds."""
    from gpvecchia_torch.kernels import matern_solve as MS
    stats = torch.zeros(len(MS.STATS_FIELDS), dtype=torch.int64, device=dev)
    launch(stats)
    return dict(zip(MS.STATS_FIELDS, stats.tolist()))


def gen_list_edge_phase(dev, seed, n=1001):
    """The general H1 and H5 on the shared-memory route against their plain
    versions (``gen_run``, not timed) on the batches above, with each
    launch's counts held to the host's: every listed pair once, none on the
    branch a batch does not reach; then a batch with one matrix not SPD at
    those F."""
    from gpvecchia_torch.kernels import matern_solve as MS
    h1g = KernelCheck("matern_solve_e0[general] list")
    h5g = KernelCheck("matern_solve_e0_bwd[general] list")
    rng = np.random.default_rng(seed)
    fs = set()
    for dt in (torch.float64, torch.float32):
        for F in GEN_LIST_FS + (MS.max_neighbors(2, dt),):
            fs.add(F)
            locs, NN, valid, resp = morton_points(n, F, seed + F)
            dist = _pair_dists(locs, NN, valid)
            drop = valid & (rng.random(size=valid.shape) < GEN_LIST_DROP)
            drop[:, 0] = False
            for case, rho, v in (
                    ("straddle", np.median(dist) / 3, valid),
                    ("below 3", dist.max() / 2.9, valid),
                    ("above 3", dist.min() / 3.1, valid),
                    ("invalid slots", np.median(dist) / 3, valid & ~drop)):
                label = f"n={n} F={F} {case}"
                cp = (1.0, float(rho), 0.8)
                with shared_route(dt):
                    gen_run(h1g, h5g, locs, NN, v, resp & v, cp, label,
                            False, dev, dtypes=(dt,), timed=False)
                    args = _h15_inputs(locs, NN, v, resp & v,
                                       np.full(len(locs), NUGGET), dev,
                                       cp)(dt)
                    x = MS.matern_solve_e0_plain(*args)
                    counts = [gen_counts(lambda st: MS._launch(
                        *args, stats=st), dev), gen_counts(
                            lambda st: MS._launch_bwd(
                                *args, x, torch.zeros_like(x), stats=st), dev)]
                s = _pair_dists(locs, NN, v) / rho
                want = dict(temme_pairs=int((s <= 3).sum()),
                            cf2_pairs=int((s > 3).sum()))
                for c in counts:
                    got = {k: c[k] for k in want}
                    empty = {"below 3": "cf2_pairs",
                             "above 3": "temme_pairs"}.get(case)
                    if c["temme_pairs"] + c["cf2_pairs"] != len(s) or (
                            empty and got[empty]) or c["points"] != n:
                        raise AssertionError(f"general list {label} {dt}: "
                                             f"counts {c}, host {want}")
                log(f"  general list {label} {str(dt)[6:]}: {want} (host), "
                    f"kernel counts {counts[0]}")
    with shared_route(torch.float32):
        non_spd_check(dev, seed, n, GEN_COVPARMS, "general H1/H5 list",
                      tuple(sorted(fs)))


# Float64, on the shared-memory route: the general H1 and H5 on the rows of
# an SGV and an MRA spec (at m = 40 the main path's shape) at these ranges
# (the mle cells' box), smoothness 0.8, with their engagement counts
GEN_ENGAGE_RANGES = (0.05, 0.1, 0.2)


def gen_engagement(specs, dev, seed):
    """For each (label, spec): the share of listed pairs on CF2's branch,
    the lanes busy in a warp pass of the pair list against the column
    walk's over the same pairs, the list's passes that ran both branches,
    and H1's and H5's ms (median of 3), H5 with a normal cotangent; both
    launches' counts must agree.  Returns the rows."""
    from gpvecchia_torch.kernels import matern_solve as MS
    from gpvecchia_torch.plan import get_plan
    dt = torch.float64
    rows = []
    for label, spec in specs:
        plan = get_plan(spec)
        args = (torch.as_tensor(plan.locs, dtype=dt, device=dev),
                torch.as_tensor(plan.NN, device=dev),
                torch.as_tensor(plan.valid, device=dev),
                torch.as_tensor(plan.valid & ~plan.cond, device=dev),
                torch.full((plan.n_all,), NUGGET, dtype=dt, device=dev))
        g = torch.Generator(device=dev).manual_seed(seed)
        xbar = torch.randn(plan.NN.shape, generator=g, dtype=dt, device=dev)
        for rho in GEN_ENGAGE_RANGES:
            cp = torch.tensor((1.0, rho, 0.8), dtype=torch.float64)
            with shared_route(dt):
                x = MS._launch(*args, cp)
                fwd = gen_counts(lambda st: MS._launch(*args, cp, stats=st),
                                 dev)
                bwd = gen_counts(lambda st: MS._launch_bwd(
                    *args, cp, x, xbar, stats=st), dev)
                ms1 = cuda_time(lambda: MS._launch(*args, cp), 3)
                ms5 = cuda_time(lambda: MS._launch_bwd(*args, cp, x, xbar), 3)
            if fwd != bwd:
                raise AssertionError(f"{label}: H1 counts {fwd}, H5 {bwd}")
            pairs = fwd["temme_pairs"] + fwd["cf2_pairs"]
            row = dict(spec=label, F=plan.NN.shape[1], range=rho,
                       pairs_per_point=pairs / fwd["points"],
                       cf2_share=fwd["cf2_pairs"] / pairs,
                       list_busy=pairs / (32 * fwd["list_passes"]),
                       walk_busy=pairs / (32 * fwd["column_passes"]),
                       mixed_share=fwd["mixed_passes"] / fwd["list_passes"],
                       h1_ms=ms1, h5_ms=ms5, counts=fwd)
            rows.append(row)
            log(f"  general pair pass {label} F={row['F']} range {rho}: "
                f"{row['pairs_per_point']:.1f} pairs a point, "
                f"{100 * row['cf2_share']:.2f} % on CF2; lanes busy "
                f"{100 * row['list_busy']:.1f} % (list) vs "
                f"{100 * row['walk_busy']:.1f} % (column walk); "
                f"{100 * row['mixed_share']:.2f} % of list passes on both "
                f"branches; H1 {ms1:.2f} ms, H5 {ms5:.2f} ms")
        del args, xbar, x
    return rows


def h8_edge_phase(dev, seed, n=1001):
    """H8 solve_e0 and solve_e0_bwd at the edge shapes of both routes, on
    random SPD packed matrices (G G^T / F + I in float64; the float32
    inputs are them rounded), by KernelCheck's rule (not timed); their
    padding bit for bit (a batch at F against the same matrices
    identity-extended to the next instantiated size: x and gbar equal on
    the F block, 0 elsewhere); a batch with one matrix not SPD: NaN/Inf in
    its row only, the other rows held."""
    from gpvecchia_torch.kernels import matern_solve as MS
    h8 = KernelCheck("solve_e0 edge")
    k2 = KernelCheck("solve_e0_bwd edge")
    g = torch.Generator(device=dev).manual_seed(seed)

    def packed(C):
        iu, ju = torch.triu_indices(C.shape[-1], C.shape[-1], device=dev)
        return C[:, iu, ju]

    def inputs(C):
        Cp = packed(C)
        xbar = torch.randn(C.shape[:2], generator=g, dtype=torch.float64,
                           device=dev)
        return Cp, MS.solve_e0_plain(Cp), xbar

    for F, dtypes in _edge_fs():
        Cp, x, xbar = inputs(_spd_fronts(n, F, seed + F, dev))
        label = f"n={n} F={F} ({MS.route(F, dtypes[-1])})"
        h8.run(label, lambda dt: (Cp.to(dt),), MS.solve_e0,
               MS.solve_e0_plain, lambda r: r, lambda dt: (0, 0.0),
               main=False, dtypes=tuple(dtypes), timed=False)
        k2.run(label, lambda dt: (Cp.to(dt), x.to(dt), xbar.to(dt)),
               MS.solve_e0_bwd, MS.solve_e0_bwd_plain, lambda r: r,
               lambda dt: (0, 0.0), main=False, dtypes=tuple(dtypes),
               timed=False)

    for F, FP in ((21, 24), (41, 48)):
        C = _spd_fronts(n, F, seed + F, dev)
        W = torch.eye(FP, dtype=torch.float64, device=dev).repeat(n, 1, 1)
        W[:, :F, :F] = C
        (Cp, x, xbar), Wp = inputs(C), packed(W)
        block = packed(torch.nn.functional.pad(
            torch.ones(1, F, F, device=dev), (0, FP - F, 0, FP - F)))[0] > 0
        for dt in (torch.float64, torch.float32):
            x_a, x_b = MS.solve_e0(Cp.to(dt)), MS.solve_e0(Wp.to(dt))
            g_a = MS.solve_e0_bwd(Cp.to(dt), x_a, xbar.to(dt))
            g_b = MS.solve_e0_bwd(Wp.to(dt), x_b, torch.nn.functional.pad(
                xbar.to(dt), (0, FP - F)))
            torch.cuda.synchronize()
            if not (torch.equal(x_a, x_b[:, :F]) and not x_b[:, F:].any()
                    and torch.equal(g_a, g_b[:, block])
                    and not g_b[:, ~block].any()):
                raise AssertionError(f"H8/solve_e0_bwd F={F} {dt}: padding "
                                     f"to {FP} is not exact")

    for F in (41, 72):
        C = _spd_fronts(n, F, seed + 2 * F, dev)
        p0 = n // 2
        C[p0, 5, 5] = -1.0
        Cp = packed(C)
        xbar = torch.randn((n, F), generator=g, dtype=torch.float64,
                           device=dev)
        rows = torch.arange(n, device=dev) != p0
        x64 = MS.solve_e0_plain(Cp)
        for dt in (torch.float64, torch.float32):
            if F > MS.max_neighbors(2, dt):
                continue
            x_p = MS.solve_e0_plain(Cp.to(dt))
            x_k = MS.solve_e0(Cp.to(dt))
            xin = torch.where(rows[:, None], x_p, 0.0)
            g_k = MS.solve_e0_bwd(Cp.to(dt), xin, xbar.to(dt))
            g_p = MS.solve_e0_bwd_plain(Cp.to(dt), xin, xbar.to(dt))
            g64 = MS.solve_e0_bwd_plain(Cp, torch.where(rows[:, None], x64,
                                                        0.0), xbar)
            torch.cuda.synchronize()
            for k, p, r in ((x_k, x_p, x64), (g_k, g_p, g64)):
                if bool(torch.isfinite(k[p0]).all()) or not bool(
                        torch.isfinite(k[rows]).all()):
                    raise AssertionError(f"H8/solve_e0_bwd F={F} {dt}: a "
                                         f"matrix not SPD did not give "
                                         f"NaN/Inf in its row only")
                k, p, r = k.double()[rows], p.double()[rows], r[rows]
                _, held, tol = _rule(k, p, r, r.abs().max().item(), dt)
                if not held <= tol:
                    raise AssertionError(f"H8/solve_e0_bwd F={F} {dt}: rows "
                                         f"beside the non-SPD one: "
                                         f"{held:.3e} > {tol:.3e}")
    log(f"  H8/solve_e0_bwd padding (F=21, 41 against 24, 48) bit for bit, "
        f"and one matrix not SPD (F=41, 72): NaN/Inf in its row only, the "
        f"other {n - 1} rows held, f64 and f32")


def padding_check(dev, seed, n, covparms, name):
    """The register route's padding: a kernel call at F against one at the
    next instantiated size with the extra slots invalid, bit for bit (x,
    dpar, dslot), with 0 in the padded slots."""
    from gpvecchia_torch.kernels import matern_solve as MS
    for F, FP in ((21, 24), (41, 48)):
        locs, NN, valid, resp = morton_points(n, F, seed + F)
        pad = FP - F
        wide = [np.concatenate([a, np.full((n, pad), 0, a.dtype)], 1)
                for a in (NN, valid, resp)]
        xbar = np.random.default_rng(seed).normal(size=(n, F))
        for dt in (torch.float64, torch.float32):
            nug = np.full(len(locs), NUGGET)
            a = _h15_inputs(locs, NN, valid, resp, nug, dev, covparms)(dt)
            b = _h15_inputs(locs, *wide, nug, dev, covparms)(dt)
            x_a, x_b = MS._launch(*a), MS._launch(*b)
            xb = torch.as_tensor(xbar, dtype=dt, device=dev)
            g_a = MS._launch_bwd(*a, x_a, xb)
            g_b = MS._launch_bwd(*b, x_b, torch.cat(
                [xb, xb.new_zeros(n, pad)], 1))
            torch.cuda.synchronize()
            if not (torch.equal(x_a, x_b[:, :F]) and not x_b[:, F:].any()
                    and torch.equal(g_a[0], g_b[0])
                    and torch.equal(g_a[1], g_b[1][:, :F])
                    and not g_b[1][:, F:].any()):
                raise AssertionError(f"{name} F={F} {dt}: padding to {FP} "
                                     f"is not exact")
    log(f"  {name} padding: F=21 and F=41 equal their explicitly padded "
        f"F=24 and F=48 bit for bit (x, dpar, dslot), 0 in the padded "
        f"slots, f64 and f32, covparms {covparms}")


def non_spd_check(dev, seed, n, covparms, name, fs=(41, 72)):
    """A batch in which one point's conditioning matrix is not positive
    definite (a response slot's nugget of -2 sig2 that enters no other row,
    so that pivot is negative exactly): NaN or Inf in that point's row
    only, every other row held to the plain version, at each F of ``fs``
    (by default F = 41, on the register route in float32, and 72 on the
    shared-memory route).  The reference is the float64 plain version,
    also at an F above float64's bound."""
    from gpvecchia_torch.kernels import matern_solve as MS
    sig2 = covparms[0]
    for F in fs:
        locs, NN, valid, resp = morton_points(n, F, seed + 2 * F)
        p0, s0 = n // 2, 5
        q = NN[p0, s0]
        resp = resp & (NN != q)
        resp[p0, s0] = True
        nug = np.full(len(locs), NUGGET)
        nug[q] = -2.0 * sig2
        xbar = np.random.default_rng(seed).normal(size=(n, F))
        rows = np.arange(n) != p0
        ref = None
        for dt in (torch.float64, torch.float32):
            args = _h15_inputs(locs, NN, valid, resp, nug, dev, covparms)(dt)
            x_p = MS.matern_solve_e0_plain(*args)
            xb = torch.as_tensor(xbar, dtype=dt, device=dev)
            dpar_p, dslot_p = MS.matern_solve_e0_bwd_plain(*args, x_p, xb)
            # d/dnu (the general Matern's third column of dpar) on its own
            # scale; the general Matern's float32 floors (see
            # GEN_DNU_F64_REL)
            plain = [x_p, dpar_p[:, :2], dslot_p, dpar_p[:, 2:]]
            if ref is None:     # float64's plain version, also at an F
                ref = [p.double() for p in plain]   # its kernels refuse
            if F > MS.max_neighbors(2, dt):
                continue
            x_k = MS._launch(*args)
            dpar_k, dslot_k = MS._launch_bwd(*args, x_p, xb)
            torch.cuda.synchronize()
            outs = list(zip([x_k, dpar_k[:, :2], dslot_k, dpar_k[:, 2:]],
                            plain))
            floors = ((None, GEN_F32_PAIR, GEN_F32_NUG, GEN_F32_DNU)
                      if dpar_k.shape[1] == 3 else (None,) * 4)
            for i, ((k, p), r) in enumerate(zip(outs, ref)):
                if not k.numel():
                    continue
                if bool(torch.isfinite(k[p0]).all()) or not bool(
                        torch.isfinite(k[rows]).all()):
                    raise AssertionError(f"{name} F={F} {dt}: a matrix not "
                                         f"SPD did not give NaN/Inf in its "
                                         f"row only")
                k, p, r = k.double()[rows], p.double()[rows], r[rows]
                scale = r.abs().max().item()
                err, held, tol = _rule(k, p, r, scale, dt, f64_tol=(
                    GEN_DNU_F64_REL if i == 3 else None),
                    f32_floor=floors[i])
                if not held <= tol:
                    raise AssertionError(f"{name} F={F} {dt}: rows beside "
                                         f"the non-SPD one: {held:.3e} > "
                                         f"{tol:.3e}")
    log(f"  {name} with one matrix not SPD (F = {fs}): NaN/Inf in its row "
        f"only, the other {n - 1} rows held, f64 and f32")


def kernel_phase(spec, mf, seed, dev):
    from gpvecchia_torch.geometry.neighbors import find_ordered_nn
    from gpvecchia_torch.geometry.sgv import which_cond_on_latent
    from gpvecchia_torch.kernels import matern_solve as MS
    from gpvecchia_torch.linalg import frontal as FR

    rng = np.random.default_rng(seed)
    checks = {}

    # ---- H1 and H5 at F = 11, 21, 41 on this spec's points, then at their
    # edge shapes ----
    h1 = checks["matern_solve_e0"] = KernelCheck("matern_solve_e0")
    h5 = checks["matern_solve_e0_bwd"] = KernelCheck("matern_solve_e0_bwd")
    m = spec.m
    inputs = {}
    for F in (11, 21, 41):
        if F <= m + 1:
            NN = spec.NNarray[:, :F]
        else:
            NN = find_ordered_nn(spec.locsord, F - 1)
        cond = which_cond_on_latent(NN) & (NN >= 0)
        valid = NN >= 0
        inputs[F] = (np.where(valid, NN, 0).astype(np.int32), valid,
                     valid & ~cond)
        h15_run(h1, h5, spec.locsord, *inputs[F], f"n={NN.shape[0]} F={F}",
                F == m + 1, seed + F, dev)
    h15_edge_phase(dev, seed)

    # ---- the general Matern (smoothness 0.8) on H1 and H5's routes at the
    # same F; at n > 1e5 the F off the main path on the first GEN_SUB_N
    # points, and the plain versions timed once ----
    h1g = checks["matern_solve_e0[general]"] = KernelCheck(
        "matern_solve_e0[general]")
    h5g = checks["matern_solve_e0_bwd[general]"] = KernelCheck(
        "matern_solve_e0_bwd[general]")
    big = spec.locsord.shape[0] > 100_000
    for F, arrays in inputs.items():
        main = F == m + 1
        rows = slice(None) if main or not big else slice(0, GEN_SUB_N)
        arrays = tuple(a[rows] for a in arrays)
        gen_run(h1g, h5g, spec.locsord, *arrays, GEN_COVPARMS,
                f"n={arrays[0].shape[0]} F={F} (nu 0.8)", main, dev,
                plain_reps=1 if big else 3)
    del inputs
    gen_edge_phase(dev, seed)
    gen_list_edge_phase(dev, seed)

    # ---- H8 solve_e0 and solve_e0_bwd at the general path's shape: the
    # packed smoothness-0.8 covariances of the first row chunk ----
    chunk = _first_chunk(spec, dev)
    F = chunk["NN"].shape[1]
    Cp64 = _packed_cov(chunk, GEN_COVPARMS)
    n8, P8 = Cp64.shape
    well = _cond64(Cp64, F) <= F32_COND_MAX

    def cost_h8(dt):
        sz = _size(dt)
        return n8 * (P8 + F) * sz, n8 * _chol_solve_ops(F)

    h8 = checks["solve_e0"] = KernelCheck("solve_e0")
    h8.run(f"n={n8} F={F} (nu 0.8)", lambda dt: (Cp64.to(dt),), MS.solve_e0,
           MS.solve_e0_plain, lambda x: x, cost_h8,
           library=lambda dt: _library_solve(MS._unpack(Cp64.to(dt), F)),
           f32_rows=well)
    k2_main = (Cp64, MS.solve_e0_plain(Cp64),
               torch.randn(n8, F, generator=torch.Generator(device=dev)
                           .manual_seed(seed), dtype=torch.float64,
                           device=dev))
    del Cp64

    def cost_k2(dt, n=n8, F=F):
        sz = _size(dt)
        P = F * (F + 1) // 2
        return 2 * n * (P + F) * sz, n * (_chol_solve_ops(F) + 3 * P)

    k2 = checks["solve_e0_bwd"] = KernelCheck("solve_e0_bwd")
    k2.run(f"n={n8} F={F} (nu 0.8)", lambda dt: tuple(t.to(dt)
                                                      for t in k2_main),
           MS.solve_e0_bwd, MS.solve_e0_bwd_plain, lambda r: r, cost_k2,
           f32_rows=well)
    del k2_main, chunk

    h8_edge_phase(dev, seed)

    # ---- solve_e0_bwd (K2 one to one) at F = 41 on random SPD matrices --
    n2, F = 65536, 41
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(n2, F, F, generator=g, dtype=torch.float64,
                    device=dev) / F ** 0.5
    C = A @ A.mT + torch.eye(F, dtype=torch.float64, device=dev)
    e0 = torch.zeros(n2, F, 1, dtype=torch.float64, device=dev)
    e0[:, 0] = 1.0
    x = torch.linalg.solve(C, e0)[..., 0]
    iu, ju = torch.triu_indices(F, F, device=dev)
    k2_in = (C[:, iu, ju], x,
             torch.randn(n2, F, generator=g, dtype=torch.float64, device=dev))
    del A, C, e0
    k2.run(f"n={n2} F={F} (SPD)", lambda dt: tuple(t.to(dt) for t in k2_in),
           MS.solve_e0_bwd, MS.solve_e0_bwd_plain, lambda r: r,
           lambda dt: cost_k2(dt, n2, F), main=False)
    del k2_in

    checks.update(leaf_phase(mf, seed, dev))

    return checks


def cost_h2(dt, N, F1, epos, n_in, ops):
    """(bytes, operations) of H2: epos and the ``n_in`` values of u,
    rhs_elem, dvec and rvec read once, each front's lower triangle (all H2
    writes) written once; ``ops`` operations."""
    sz = _size(dt)
    return epos.size * 4 + n_in * sz + N * F1 * (F1 + 1) // 2 * sz, ops


def cost_h3(dt, N, F1, ext):
    """(bytes, operations) of H3 on N fronts with the augmented map ``ext``
    (N, 2, F1): ext, dvec and rvec read once, of each child the lower
    triangle of the b x b entries its b valid positions gather (its lower
    triangle, since ext is monotone) read once, and each front's lower
    triangle written once; one addition a gathered entry."""
    sz = _size(dt)
    b = (ext >= 0).sum(-1)
    gathered = float((b * (b + 1) // 2).sum())
    return (ext.size * 4 + 2 * N * F1 * sz + gathered * sz
            + N * F1 * (F1 + 1) // 2 * sz), gathered


def cost_h6(dt, N, F1, Bc1, ext):
    """(bytes, operations) of H6, the transpose of H3 on lower triangles:
    ext read once, of the front cotangent's lower triangle the entries the
    children gather (those H3 reads of them) and its diagonal and row F1-1
    read once, each child block's lower triangle read and written once
    (``out +=``), d dvec and d rvec written; one addition a gathered
    entry."""
    sz = _size(dt)
    b = (ext >= 0).sum(-1)
    gathered = float((b * (b + 1) // 2).sum())
    return (ext.size * 4 + gathered * sz + 2 * N * F1 * sz
            + 2 * 2 * N * Bc1 * (Bc1 + 1) // 2 * sz + 2 * N * F1 * sz), \
        gathered


def _ext_aug(lv, F1, Bc1):
    """A level's (N, 2, F1) int32 ext map with the augmented entry, as
    ``multifrontal.mf_device_arrays`` builds it."""
    ext = np.full((lv.piv_ids.shape[0], 2, F1), -1, np.int32)
    ext[:, :, :F1 - 1] = lv.ext
    ext[:, :, F1 - 1] = Bc1 - 1
    return ext


def _widest_level(mf):
    """The internal level with the widest front (None for a one-level
    plan): the main shape of H3 and H6 in the ``kernels`` line."""
    return max(range(mf.depth), key=lambda d: mf.levels[d].front,
               default=None)


def _exact_rule(part, k, p, r, dt):
    """KernelCheck's rule for H3: the kernel equals its plain version in
    the same dtype bit for bit (an extend-add has no products, and both
    add child 0, child 1, D and the RHS row in that order)."""
    same = torch.equal(k, p)
    err = (k - p).abs().max().item()
    held = 0.0 if same else (err or float("inf"))
    return err, held, 0.0, r.abs().max().item(), " bit for bit"


def _same_twice(name, launch):
    """Two launches on the same inputs give the same bits."""
    a, b = launch(), launch()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ")


def leaf_phase(mf, seed, dev):
    """H2 and H7 at the leaf's shape of the plan: H2 by ``_rule``, its two
    launches bit for bit; returns their KernelChecks."""
    from gpvecchia_torch.linalg import frontal as FR
    rng = np.random.default_rng(seed)
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
    # each real element adds the lower triangle of its (k+1)-vector's
    # outer product (k valid slots and the rhs), one FMA (2 operations) an
    # entry
    k_e = (epos >= 0).sum(-1)[leaf.elem_pt >= 0]
    leaf_ops = float(((k_e + 1) * (k_e + 2)).sum())
    n_in = u.size + re.size + dv.size + rv.size
    h2 = KernelCheck("leaf_assemble")
    h2.run(label, mk_leaf, FR.leaf_assemble, FR.leaf_assemble_plain,
           torch.tril, lambda dt: cost_h2(dt, N, F1, epos, n_in, leaf_ops))
    for dt in (torch.float64, torch.float32):
        args = mk_leaf(dt)
        _same_twice(f"leaf_assemble {label} {dt}",
                    lambda: torch.tril(FR.leaf_assemble(*args)))
    del args

    # H7 reads the cotangent's lower triangle, as H9 leaves it: the kernel
    # gets NaN above the diagonal, the plain version the symmetric matrix
    h7 = KernelCheck("leaf_assemble_bwd")
    dfront = {torch.float64: _nan_upper(_sym_randn((N, F1, F1), seed + 7,
                                                   dev))}
    dfront[torch.float32] = dfront[torch.float64].float()

    def cost_h7(dt):
        # dfront's lower triangle, u, epos, rhs_elem in; du, d rhs_elem,
        # d dvec, d rvec out
        sz = _size(dt)
        return (N * F1 * (F1 + 1) // 2 * sz + epos.size * 4
                + 2 * (u.size + re.size) * sz + 2 * N * F1 * sz), leaf_ops

    h7.run(label, lambda dt: (dfront[dt],) + mk_leaf(dt)[:3],
           FR.leaf_assemble_bwd,
           lambda d, *a: FR.leaf_assemble_bwd_plain(FR._sym_lower(d), *a),
           lambda r: r, cost_h7)
    for row in h7.rows:
        log(f"  leaf_assemble_bwd {label} {row['dtype']}: kernel "
            f"{row['ms']:.3f} ms against its bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}): {row['bound_ms'] / row['ms']:.1%} of it")
    return {"leaf_assemble": h2, "leaf_assemble_bwd": h7}


def eadd_level_phase(mf, dev, seed, h6=True):
    """H3 at every internal level of the plan on the plan's own ext maps
    and symmetric normal child blocks, read, as on the main path, through a
    strided view of (2N, F1c, F1c) child fronts: the kernel equals its
    plain version bit for bit in float64 and float32, two launches give the
    same bits; one row a level and dtype (ms, bound, the bound's share of
    the time) and the sums over the levels.  With ``h6`` also H6 at every
    level (``h6_level_check``), its rows and sums alike.  Returns (rows,
    sums, H3's KernelCheck, H6's or None; the main shape of both is the
    widest level)."""
    from gpvecchia_torch.linalg import frontal as FR
    chk = KernelCheck("extend_add")
    h6_chk = KernelCheck("extend_add_bwd") if h6 else None
    rows = []
    d_main = _widest_level(mf)
    for d in range(mf.depth):
        lv, lc = mf.levels[d], mf.levels[d + 1]
        N, P = lv.piv_ids.shape[0], lv.npiv
        F1 = P + lv.nbord + 1
        Pc, Bc1 = lc.npiv, lc.nbord + 1
        F1c = Pc + Bc1
        ext = _ext_aug(lv, F1, Bc1)
        ext_t = torch.as_tensor(ext, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + d)
        kids = {torch.float64: torch.zeros(2 * N, F1c, F1c,
                                           dtype=torch.float64, device=dev)}
        blk = torch.randn(2 * N, Bc1, Bc1, generator=g, dtype=torch.float64,
                          device=dev)
        kids[torch.float64][:, Pc:, Pc:] = blk + blk.mT
        del blk
        kids[torch.float32] = kids[torch.float64].float()
        vec = {}
        for dt in (torch.float64, torch.float32):
            dv = torch.zeros(N, F1, dtype=dt, device=dev)
            dv[:, :P] = 1.0 / NUGGET
            rv = torch.randn(N, F1, generator=g, dtype=torch.float64,
                             device=dev).to(dt)
            rv[:, F1 - 1] = 0.0
            vec[dt] = (dv, rv)

        def mk(dt):
            return ((kids[dt][:, Pc:, Pc:].unflatten(0, (N, 2)), ext_t)
                    + vec[dt])

        chk.run(f"level {d} N={N} Bc1={Bc1} F1={F1}", mk, FR.extend_add,
                FR.extend_add_plain, torch.tril,
                lambda dt: cost_h3(dt, N, F1, ext), main=d == d_main,
                rule=_exact_rule)
        for dt in (torch.float64, torch.float32):
            args = mk(dt)
            _same_twice(f"extend_add level {d} {dt}",
                        lambda: torch.tril(FR.extend_add(*args)))
        del kids, vec, args
        torch.cuda.empty_cache()
        for row in chk.rows[-2:]:
            rows.append(dict(level=d, N=N, F1=F1, Bc1=Bc1, dtype=row["dtype"],
                             ms=row["ms"], plain_ms=row["plain_ms"],
                             bound_ms=row["bound_ms"],
                             share=row["bound_ms"] / row["ms"]))
        if h6:
            h6_level_check(h6_chk, d, N, F1, Pc, Bc1, ext, ext_t, d == d_main,
                           dev, seed)
            for r, row in zip(rows[-2:], h6_chk.rows[-2:]):
                r.update(h6_ms=row["ms"], h6_plain_ms=row["plain_ms"],
                         h6_bound_ms=row["bound_ms"])
    sums = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        rs = [r for r in rows if r["dtype"] == name]
        if not rs:                      # a one-level plan has no H3
            continue
        log(f"  H3 by level, {name}: level N F1 Bc1 | kernel ms | plain ms | "
            f"bound ms | share of bound")
        for r in rs:
            log(f"    {r['level']:2d} {r['N']:5d} {r['F1']:5d} {r['Bc1']:5d} | "
                f"{r['ms']:8.3f} | {r['plain_ms']:8.3f} | {r['bound_ms']:7.3f}"
                f" | {100 * r['share']:5.1f} %")
        ms, bound = sum(r["ms"] for r in rs), sum(r["bound_ms"] for r in rs)
        sums[name] = dict(levels=len(rs), extend_add_ms=ms,
                          extend_add_bound_ms=bound)
        log(f"  H3 summed over the {len(rs)} internal levels, {name}: kernel "
            f"{ms:.3f} ms, bound {bound:.3f} ms ({100 * bound / ms:.1f} %)")
        if h6:
            log(f"  H6 by level, {name}: level N F1 Bc1 | kernel ms | plain "
                f"ms | bound ms | share of bound")
            for r in rs:
                log(f"    {r['level']:2d} {r['N']:5d} {r['F1']:5d} "
                    f"{r['Bc1']:5d} | {r['h6_ms']:8.3f} | "
                    f"{r['h6_plain_ms']:8.3f} | {r['h6_bound_ms']:7.3f} | "
                    f"{100 * r['h6_bound_ms'] / r['h6_ms']:5.1f} %")
            ms6 = sum(r["h6_ms"] for r in rs)
            b6 = sum(r["h6_bound_ms"] for r in rs)
            sums[name].update(extend_add_bwd_ms=ms6,
                              extend_add_bwd_bound_ms=b6)
            log(f"  H6 summed over the {len(rs)} internal levels, {name}: "
                f"kernel {ms6:.3f} ms, bound {b6:.3f} ms "
                f"({100 * b6 / ms6:.1f} %)")
    return rows, sums, chk, h6_chk


def h6_level_check(chk, d, N, F1, Pc, Bc1, ext, ext_t, main, dev, seed):
    """H6 at one internal level on the plan's ext map: it adds, as on the
    main path, into the child fronts' [Pc:, Pc:] blocks through a strided
    view of a (2N, F1c, F1c) buffer of zeros, from a cotangent whose
    strict upper triangle is NaN; the plain version gets the symmetric
    cotangent.  The lower triangles of the blocks and d dvec, d rvec equal
    the plain version's bit for bit, and the rest of the buffer (the
    blocks' upper triangles too) stays 0."""
    from gpvecchia_torch.linalg import frontal as FR
    F1c = Pc + Bc1
    dfront = {torch.float64: _nan_upper(_sym_randn((N, F1, F1), seed + 6 + d,
                                                   dev))}
    dfront[torch.float32] = dfront[torch.float64].float()
    low = torch.ones(Bc1, Bc1, dtype=torch.bool, device=dev).tril()

    def mk(dt):
        return (dfront[dt], ext_t,
                torch.zeros(2 * N, F1c, F1c, dtype=dt, device=dev))

    def blocks(buf):
        return buf[:, Pc:, Pc:].unflatten(0, (-1, 2))

    def kernel(dd, e, buf):
        return (blocks(buf),) + FR.extend_add_bwd(dd, e, blocks(buf)) \
            + (buf,)

    def plain(dd, e, buf):
        return FR.extend_add_bwd_plain(FR._sym_lower(dd), e, Bc1) + (None,)

    def out_of(r):
        """(lower triangles of dupd, d dvec, d rvec, largest |entry| of the
        buffer outside those triangles); the plain version writes no
        buffer."""
        buf = r[3]
        rest = torch.zeros((), device=dev)
        if buf is not None:
            rest = buf.clone()
            blocks(rest).masked_fill_(low, 0.0)
            rest = rest.abs().amax()
        return (r[0].masked_fill(~low, 0.0),) + r[1:3] + (rest,)

    chk.run(f"level {d} N={N} Bc1={Bc1} F1={F1} F1c={F1c}", mk, kernel,
            plain, out_of, lambda dt: cost_h6(dt, N, F1, Bc1, ext),
            mutates=True, main=main, rule=_exact_rule)
    del dfront
    torch.cuda.empty_cache()


def assembly_edge_phase(dev, seed, guard=4096):
    """H3 and H2 at their edge shapes (``H3_EDGE_SHAPES``,
    ``H2_EDGE_SHAPES``), float64 and float32, each launched twice into a
    buffer whose upper triangles and ``guard`` values past the last front
    hold 7.0: the two buffers equal bit for bit, those values stay 7.0,
    and the lower triangles equal the plain version's bit for bit (H3) or
    hold ``_rule`` against it (H2)."""
    from gpvecchia_torch.linalg import frontal as FR
    worst = {torch.float64: 0.0, torch.float32: 0.0}

    def launched(name, launch, dt, N, F1):
        outs = []
        for _ in range(2):
            buf = torch.full((N * F1 * F1 + guard,), 7.0, dtype=dt, device=dev)
            launch(buf[:N * F1 * F1].view(N, F1, F1))
            outs.append(buf)
        torch.cuda.synchronize()
        front = outs[0][:N * F1 * F1].view(N, F1, F1)
        up = torch.ones(F1, F1, dtype=torch.bool, device=dev).triu(1)
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{name} {dt}: two launches differ")
        if not (bool((front[:, up] == 7.0).all())
                and bool((outs[0][N * F1 * F1:] == 7.0).all())):
            raise AssertionError(f"{name} {dt}: wrote outside the lower "
                                 f"triangles")
        return torch.tril(front)

    for idx, shape in enumerate(FR.H3_EDGE_SHAPES):
        N, F1 = shape[:2]
        cpu = FR.h3_edge_inputs(*shape, seed=seed + idx)
        for dt in (torch.float64, torch.float32):
            upd, ext, dv, rv = (t.to(dev, dt) if t.is_floating_point()
                                else t.to(dev) for t in cpu)
            name = f"extend_add {shape}"
            k = launched(name, lambda f: FR._eadd_launch(upd, ext, dv, rv, f),
                         dt, N, F1)
            p = torch.tril(FR.extend_add_plain(upd, ext, dv, rv))
            if not torch.equal(k, p):
                raise AssertionError(f"{name} {dt}: not bit for bit its plain "
                                     f"version ({(k - p).abs().max():.3e})")
    for idx, shape in enumerate(FR.H2_EDGE_SHAPES):
        N, F1 = shape[:2]
        cpu = FR.h2_edge_inputs(*shape, seed=seed + idx)
        ref = torch.tril(FR.leaf_assemble_plain(
            *(t.to(dev) for t in cpu))).double()
        for dt in (torch.float64, torch.float32):
            u, epos, re, dv, rv = (t.to(dev, dt) if t.is_floating_point()
                                   else t.to(dev) for t in cpu)
            name = f"leaf_assemble {shape}"
            k = launched(name,
                         lambda f: FR._leaf_launch(u, epos, re, dv, rv, f),
                         dt, N, F1)
            p = torch.tril(FR.leaf_assemble_plain(u, epos, re, dv, rv))
            scale = ref.abs().max().item()
            err, held, tol = _rule(k.double(), p.double(), ref, scale, dt)
            if not (held <= tol and np.isfinite(err)):
                raise AssertionError(f"{name} {dt}: kernel disagrees with its "
                                     f"plain version: {held:.3e} > {tol:.3e}")
            worst[dt] = max(worst[dt], held / tol)
    log(f"  extend_add edge shapes: {len(FR.H3_EDGE_SHAPES)} shapes bit for "
        f"bit the plain version in f64 and f32; leaf_assemble edge shapes: "
        f"{len(FR.H2_EDGE_SHAPES)} shapes, largest held/tol f64 "
        f"{worst[torch.float64]:.3f}, f32 {worst[torch.float32]:.3f}; both "
        f"launched twice with the same bits, upper triangles and "
        f"{guard} guard values untouched")


# ``--only-h15``: H1 and H5 at these F on H15_N Z-ordered points (F = 72
# takes the shared-memory route in both dtypes)
H15_FS = (11, 21, 41, 72)
H15_N = 1_000_000

# (N, F1, P) of the 14 levels of the multifrontal plan of n=1e6, m=40, SGV,
# seed 1988 (root first, leaf last): what ``--only-h4`` runs without a spec
H4_LEVELS_1E6 = (
    (1, 3495, 3494), (2, 5233, 1738), (4, 5270, 1709), (8, 5247, 847),
    (16, 4388, 869), (32, 3131, 439), (64, 2301, 448), (128, 1628, 234),
    (256, 1185, 224), (512, 830, 113), (1024, 614, 110), (2048, 451, 55),
    (4096, 334, 62), (8192, 330, 105))
# a level phase holds at most this many bytes of float32 fronts; a level
# with more is run on fewer fronts and its time scaled to its real count
H4_LEVEL_BYTES = 4e9


def _spd_fronts(N, F1, seed, dev, chunk_bytes=1e9):
    """N float64 SPD fronts G G^T / F1 + I made on the card, G normal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty(N, F1, F1, dtype=torch.float64, device=dev)
    step = max(1, int(chunk_bytes // (8 * F1 * F1)))
    eye = torch.eye(F1, dtype=torch.float64, device=dev)
    for s in range(0, N, step):
        G = torch.randn(out[s:s + step].shape, generator=g,
                        dtype=torch.float64, device=dev) / F1 ** 0.5
        out[s:s + step] = G @ G.mT + eye
    return out


def _nan_upper(front):
    """A copy whose strict upper triangles are NaN."""
    F1 = front.shape[-1]
    up = torch.ones(F1, F1, dtype=torch.bool, device=front.device).triu(1)
    return front.masked_fill(up, torch.nan)


def h4_edge_phase(dev, seed):
    """H4 at the edge shapes of its schedule, kernel vs plain version in
    float64 and float32 by KernelCheck's rule.  The kernel's inputs carry
    NaN in their strict upper triangles, and its lower-triangle outputs must
    also equal, bit for bit, those it gives on the clean inputs.  Then three
    fronts of which the middle one is not SPD: its Schur block and last
    pivot are NaN, the other two fronts are held as above, and the guard
    values right after the batch stay untouched."""
    from gpvecchia_torch.linalg import frontal as FR
    worst = {torch.float64: 0.0, torch.float32: 0.0}

    def hold(k, p, r, dt, what):
        scale = r.abs().max().item()
        err, held, tol = _rule(k.double(), p.double(), r, scale, dt)
        if not (held <= tol and np.isfinite(err)):
            raise AssertionError(f"front_factor {what} {dt}: kernel "
                                 f"disagrees with its plain version: "
                                 f"{held:.3e} > {tol:.3e} (scale {scale:.3e})")
        worst[dt] = max(worst[dt], held / tol)

    for idx, (N, F1, P) in enumerate(FR.H4_EDGE_SHAPES):
        spd = _spd_fronts(N, F1, seed + idx, dev)
        ref = torch.tril(FR.front_factor_plain(spd.clone(), P))
        for dt in (torch.float64, torch.float32):
            x = spd.to(dt)
            k = torch.tril(FR.front_factor(_nan_upper(x), P))
            clean = torch.tril(FR.front_factor(x.clone(), P))
            pl = torch.tril(FR.front_factor_plain(x.clone(), P))
            torch.cuda.synchronize()
            if not torch.equal(k, clean):
                raise AssertionError(f"front_factor N={N} F1={F1} P={P} {dt}:"
                                     f" the upper triangle reached the output")
            hold(k, pl, ref, dt, f"N={N} F1={F1} P={P}")

    N, F1, P, guard = 3, 300, 200, 4096
    spd = _spd_fronts(N, F1, seed + 100, dev)
    spd[1, P // 2, P // 2] = -1.0
    ref = torch.tril(FR.front_factor_plain(spd.clone(), P))
    for dt in (torch.float64, torch.float32):
        buf = torch.full((N * F1 * F1 + guard,), 7.0, dtype=dt, device=dev)
        fronts = buf[:N * F1 * F1].view(N, F1, F1)
        fronts.copy_(_nan_upper(spd.to(dt)))
        k = torch.tril(FR.front_factor(fronts, P))
        pl = torch.tril(FR.front_factor_plain(spd.to(dt, copy=True), P))
        torch.cuda.synchronize()
        bad = k[1]
        rows = torch.arange(F1, device=dev)
        low = rows[:, None] >= rows[None, :]
        if not (bool(torch.isnan(bad[P:, P:][low[P:, P:]]).all())
                and bool(torch.isnan(bad[P - 1, P - 1]))
                and bool(torch.isnan(pl[1]).any())):
            raise AssertionError(f"front_factor {dt}: a front that is not "
                                 f"SPD did not give NaN")
        if not bool((buf[N * F1 * F1:] == 7.0).all()):
            raise AssertionError(f"front_factor {dt}: wrote past the batch")
        keep = [0, 2]
        hold(k[keep], pl[keep], ref[keep], dt, "beside a front not SPD")
    log(f"  front_factor edge shapes: {len(FR.H4_EDGE_SHAPES)} shapes and a "
        f"batch with a front not SPD pass in f64 and f32, NaN upper "
        f"triangles ignored; largest held/tol f64 "
        f"{worst[torch.float64]:.3f}, f32 {worst[torch.float32]:.3f}")


def h4_level_phase(shapes, dev, seed):
    """H4 at each (N, F1, P) of ``shapes`` (the levels of a multifrontal
    plan, root first) on SPD fronts, against its plain version: one row a
    level and dtype with the kernel's, the plain version's (cuSOLVER potrf,
    cuBLAS trsm and gemm) and the bound's milliseconds and the achieved
    TFLOP/s, and the sum over the levels of the times scaled to each
    level's real number of fronts: H4's share of one evaluation.  Returns
    the rows and the KernelCheck, whose last level (the leaf, the shape
    that most of the main path's fronts have) is its main shape."""
    from gpvecchia_torch.linalg import frontal as FR
    chk = KernelCheck("front_factor")
    out = []
    for lvl, (N, F1, P) in enumerate(shapes):
        n_run = min(N, max(1, int(H4_LEVEL_BYTES // (4 * F1 * F1))))
        spd = _spd_fronts(n_run, F1, seed + lvl, dev)
        fronts = {torch.float64: spd, torch.float32: spd.float()}
        chk.run(f"level {lvl} N={n_run}/{N} F1={F1} P={P}",
                lambda dt: (fronts[dt].clone(), P), FR.front_factor,
                FR.front_factor_plain, torch.tril,
                lambda dt: cost_h4(dt, n_run, F1, P), mutates=True,
                main=lvl == len(shapes) - 1)
        del fronts, spd
        torch.cuda.empty_cache()
        for row in chk.rows[-2:]:
            dt = getattr(torch, row["dtype"])
            scale = N / n_run
            out.append(dict(level=lvl, N=N, N_run=n_run, F1=F1, P=P,
                            dtype=row["dtype"], ms=row["ms"] * scale,
                            library_ms=row["plain_ms"] * scale,
                            bound_ms=row["bound_ms"] * scale,
                            bound_by=row["bound_by"],
                            tflops=cost_h4(dt, n_run, F1, P)[1]
                            / (row["ms"] * 1e9),
                            held_err=row["held_err"], tol=row["tol"]))
    for name in ("float32", "float64"):
        rows = [r for r in out if r["dtype"] == name]
        log(f"  H4 by level, {name} (times scaled to the level's N): level "
            f"N F1 P | kernel ms | library ms | bound ms | TFLOP/s")
        for r in rows:
            log(f"    {r['level']:2d} {r['N']:5d} {r['F1']:5d} {r['P']:5d} | "
                f"{r['ms']:8.3f} | {r['library_ms']:8.3f} | "
                f"{r['bound_ms']:7.3f} ({r['bound_by']}) | {r['tflops']:6.2f}")
        log(f"  H4 summed over the {len(rows)} levels, {name}: kernel "
            f"{sum(r['ms'] for r in rows):.3f} ms, library "
            f"{sum(r['library_ms'] for r in rows):.3f} ms, bound "
            f"{sum(r['bound_ms'] for r in rows):.3f} ms")
    return out, chk


# the cotangents of logdet and quad H9's checks seed with
H9_SEEDS = (0.7, -1.3)


def _h9_inputs(N, F1, P, seed, dev):
    """float64 fronts as H9 finds them on the main path: SPD fronts
    factored by H4's plain version, with a symmetric normal Schur
    cotangent in the lower triangle of [P:, P:]."""
    from gpvecchia_torch.linalg import frontal as FR
    fr = FR.front_factor_plain(_spd_fronts(N, F1, seed, dev), P)
    fr[:, P:, P:] = torch.tril(_sym_randn((N, F1 - P, F1 - P), seed + 1, dev))
    return fr


def _h9_call(fn, P):
    """fn(front, P, g_logdet, g_quad) with H9_SEEDS as 0-dim tensors of the
    front's dtype on its device."""
    def call(front):
        gl, gq = (torch.tensor(v, dtype=front.dtype, device=front.device)
                  for v in H9_SEEDS)
        return fn(front, P, gl, gq)
    return call


def h9_edge_phase(dev, seed):
    """H9 at the edge shapes of its schedule (``H9_EDGE_SHAPES``), kernel
    vs plain version in float64 and float32 by KernelCheck's rule; the
    kernel's inputs carry NaN in their strict upper triangles, and its
    lower-triangle outputs must equal, bit for bit, those it gives on the
    clean inputs; the guard values right after the batch stay untouched."""
    from gpvecchia_torch.linalg import frontal as FR
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    guard = 4096
    for idx, (N, F1, P) in enumerate(FR.H9_EDGE_SHAPES):
        fr = _h9_inputs(N, F1, P, seed + idx, dev)
        ref = torch.tril(_h9_call(FR.front_factor_bwd_plain, P)(fr.clone()))
        scale = ref.abs().max().item()
        for dt in (torch.float64, torch.float32):
            x = fr.to(dt)
            buf = torch.full((N * F1 * F1 + guard,), 7.0, dtype=dt,
                             device=dev)
            dirty = buf[:N * F1 * F1].view(N, F1, F1)
            dirty.copy_(_nan_upper(x))
            k = torch.tril(_h9_call(FR.front_factor_bwd, P)(dirty))
            clean = torch.tril(_h9_call(FR.front_factor_bwd, P)(x.clone()))
            pl = torch.tril(_h9_call(FR.front_factor_bwd_plain, P)(x.clone()))
            torch.cuda.synchronize()
            if not torch.equal(k, clean):
                raise AssertionError(f"front_factor_bwd N={N} F1={F1} P={P} "
                                     f"{dt}: the upper triangle reached the "
                                     f"output")
            if not bool((buf[N * F1 * F1:] == 7.0).all()):
                raise AssertionError(f"front_factor_bwd N={N} F1={F1} P={P} "
                                     f"{dt}: wrote past the batch")
            err, held, tol = _rule(k.double(), pl.double(), ref, scale, dt)
            if not (held <= tol and np.isfinite(err)):
                raise AssertionError(
                    f"front_factor_bwd N={N} F1={F1} P={P} {dt}: kernel "
                    f"disagrees with its plain version: {held:.3e} > "
                    f"{tol:.3e} (scale {scale:.3e})")
            worst[dt] = max(worst[dt], held / tol if tol > 0 else held)
        del fr, ref, x, buf, dirty, k, clean, pl
    torch.cuda.empty_cache()
    log(f"  front_factor_bwd edge shapes: {len(FR.H9_EDGE_SHAPES)} shapes "
        f"pass in f64 and f32, NaN upper triangles ignored; largest held/tol"
        f" f64 {worst[torch.float64]:.3f}, f32 {worst[torch.float32]:.3f}")


def h9_level_phase(shapes, dev, seed):
    """H9 at each (N, F1, P) of ``shapes`` (the levels of a multifrontal
    plan, root first) on fronts as ``_h9_inputs`` makes them, against its
    plain version (``front_factor_vjp``: cuBLAS triangular solves and
    products, and the store): one row a level and dtype with the kernel's,
    the plain version's and the bound's milliseconds, the achieved TFLOP/s
    and the errors (float64 against the plain version, float32 against the
    float64 plain version), and the sums over the levels of the times
    scaled to each level's real number of fronts: H9's share of one
    value+grad.  Returns the rows and the KernelCheck, whose last level (the
    leaf) is its main shape."""
    from gpvecchia_torch.linalg import frontal as FR
    chk = KernelCheck("front_factor_bwd")
    out = []
    for lvl, (N, F1, P) in enumerate(shapes):
        n_run = min(N, max(1, int(H4_LEVEL_BYTES // (4 * F1 * F1))))
        fr = _h9_inputs(n_run, F1, P, seed + lvl, dev)
        fronts = {torch.float64: fr, torch.float32: fr.float()}

        def cost(dt):
            return cost_h9(dt, n_run, F1, P, FR.H9_BW)

        chk.run(f"level {lvl} N={n_run}/{N} F1={F1} P={P}",
                lambda dt: (fronts[dt].clone(),),
                _h9_call(FR.front_factor_bwd, P),
                _h9_call(FR.front_factor_bwd_plain, P), torch.tril, cost,
                mutates=True, main=lvl == len(shapes) - 1)
        # the CUDA launches of one call (the schedule, splits included): the
        # trace table sums them over the calls, so read across one more
        n0 = _count("front_factor_bwd.cuda_launches")
        _h9_call(FR.front_factor_bwd, P)(fronts[torch.float32].clone())
        launches = _count("front_factor_bwd.cuda_launches") - n0
        del fronts, fr
        torch.cuda.empty_cache()
        for row in chk.rows[-2:]:
            dt = getattr(torch, row["dtype"])
            scale = N / n_run
            out.append(dict(level=lvl, N=N, N_run=n_run, F1=F1, P=P,
                            dtype=row["dtype"], ms=row["ms"] * scale,
                            plain_ms=row["plain_ms"] * scale,
                            bound_ms=row["bound_ms"] * scale,
                            bound_by=row["bound_by"],
                            tflops=cost(dt)[1] / (row["ms"] * 1e9),
                            launches=launches,
                            max_abs_err=row["max_abs_err"],
                            held_err=row["held_err"], tol=row["tol"],
                            scale=row["scale"]))
    for name in ("float32", "float64"):
        rows = [r for r in out if r["dtype"] == name]
        log(f"  H9 by level, {name} (times scaled to the level's N): level "
            f"N F1 P | kernel ms | plain ms | bound ms | TFLOP/s | CUDA "
            f"launches a front batch | held err (tol)")
        for r in rows:
            log(f"    {r['level']:2d} {r['N']:5d} {r['F1']:5d} {r['P']:5d} | "
                f"{r['ms']:8.3f} | {r['plain_ms']:8.3f} | "
                f"{r['bound_ms']:7.3f} ({r['bound_by']}) | {r['tflops']:6.2f}"
                f" | {r['launches']:4d} | {r['held_err']:.2e} "
                f"({r['tol']:.2e})")
        log(f"  H9 summed over the {len(rows)} levels, {name}: kernel "
            f"{sum(r['ms'] for r in rows):.3f} ms, plain "
            f"{sum(r['plain_ms'] for r in rows):.3f} ms, bound "
            f"{sum(r['bound_ms'] for r in rows):.3f} ms, "
            f"{sum(r['launches'] for r in rows)} CUDA launches")
    return out, chk


def _level_shapes(mf):
    """(N, F1, P) of each level of a multifrontal plan, root first."""
    return tuple((lv.piv_ids.shape[0], lv.npiv + lv.nbord + 1, lv.npiv)
                 for lv in mf.levels)


def value_grad(fn, zt, nug, covparms=COVPARMS):
    """(loglik, dcovparms, dnuggets) as host values: covparms and nuggets
    are float64 CPU tensors, so their gradients come back there."""
    c = torch.tensor(covparms, dtype=torch.float64, requires_grad=True)
    g = torch.tensor(nug, dtype=torch.float64, requires_grad=True)
    ll = fn(zt, c, g)
    dc, dg = torch.autograd.grad(ll, (c, g))
    return ll.detach().item(), dc.numpy(), dg.numpy()


def profile_eval(spec, z, grad, covparms=COVPARMS):
    """One warm f32 evaluation (value and gradient if ``grad``) under
    torch.profiler."""
    import gpvecchia_torch as gt
    fn = gt.loglik_fn(spec, device="cuda", dtype=torch.float32)
    zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")

    def once():
        if grad:
            value_grad(fn, zt, NUGGET, covparms)
        else:
            float(fn(zt, covparms, NUGGET))

    profile_call(("value+grad" if grad else "eval") + f" at {covparms}",
                 once)


def profile_pred(spec, z):
    """One warm f32 prediction mean (factor kept, back-substitution) and one
    selected inverse on its factor under torch.profiler."""
    from gpvecchia_torch.inference.prediction import _pred_fns
    (mean_fn, var_fn), _ = _pred_fns(spec, "matern", torch.device("cuda"),
                                     torch.float32)
    zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")
    held = {}

    def mean():
        held["fac"] = None
        held["fac"] = mean_fn(zt, COVPARMS, NUGGET)[1]
        torch.cuda.synchronize()

    def selinv():
        var_fn(held["fac"])
        torch.cuda.synchronize()

    profile_call(f"prediction mean at {COVPARMS}", mean)
    profile_call("prediction selected inverse", selinv)
    held.clear()


def profile_call(what, once):
    """``once()`` warm under torch.profiler: device time by kernel and the
    device's busy share of its wall time (``once`` must synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
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
                                  row_limit=30))
    log(f"profile: {what} wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f} %), "
        f"{len(spans)} device events")
    parts = h9_parts(prof)
    if parts:
        log(f"profile: {what}: H9 by part (device ms, launches): " + "; ".join(
            f"{k} {v[0]:.2f} ({v[1]})" for k, v in parts.items()))


# H9's parts, in the order its launcher runs them
H9_PARTS = ("Schur product's reverse", "panel products", "diagonal blocks",
            "panel solves", "rest")


def h9_parts(prof):
    """H9's device time split by part, from its kernels in stream order:
    the product just before each seed kernel is the Schur product's
    reverse; the product just before each diagonal kernel (T = Cbar^T C)
    belongs with it to the diagonal blocks, the one just after it is the
    panel solve, every other product is a panel product; a split product's
    reduction goes with its product; seed and final kernels are the rest.
    {part: (ms, launches)}, empty without H9 kernels."""
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "h9_" in e.name), key=lambda e: e.time_range.start)
    kind = ["seed" if "h9_seed" in e.name else "diag" if "h9_diag" in e.name
            else "final" if "h9_final" in e.name else "reduce"
            if "h9_reduce" in e.name else "gemm" for e in ev]
    gemms = [i for i, k in enumerate(kind) if k == "gemm"]
    part = [H9_PARTS[4]] * len(ev)
    for i in gemms:
        part[i] = H9_PARTS[1]
    for i, k in enumerate(kind):
        if k == "seed":
            before = max((g for g in gemms if g < i), default=None)
            if before is not None:
                part[before] = H9_PARTS[0]
        elif k == "diag":
            before = max((g for g in gemms if g < i), default=None)
            after = next((g for g in gemms if g > i), None)
            if before is not None:
                part[before] = H9_PARTS[2]
            if after is not None:
                part[after] = H9_PARTS[3]
            part[i] = H9_PARTS[2]
    for i, k in enumerate(kind):
        if k == "reduce" and i > 0:
            part[i] = part[i - 1]
    out = {p: [0.0, 0] for p in H9_PARTS}
    for e, p in zip(ev, part):
        out[p][0] += (e.time_range.end - e.time_range.start) / 1e3
        out[p][1] += 1
    return {p: tuple(v) for p, v in out.items()} if ev else {}


def grad_phase(spec, z, big, counters):
    """Value and gradient on the card; returns (results, launches, peak).
    Each kernel of ``counters`` must launch in this phase."""
    import gpvecchia_torch as gt
    nvec = np.linspace(0.05, 0.15, len(z))
    _reset(counters + ("front_factor_vjp",))
    torch.cuda.reset_peak_memory_stats()
    res = {}
    for dt in ((torch.float32,) if big else (torch.float64, torch.float32)):
        fn = gt.loglik_fn(spec, device="cuda", dtype=dt)
        zt = torch.as_tensor(z, dtype=dt, device="cuda")
        t0 = time.perf_counter()
        first = value_grad(fn, zt, NUGGET)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = value_grad(fn, zt, NUGGET)
            times.append((time.perf_counter() - t0) * 1e3)
        vec = value_grad(fn, zt, nvec)
        for r in (first, out, vec):
            if not (np.isfinite(r[0]) and np.all(np.isfinite(r[1]))
                    and np.all(np.isfinite(r[2]))):
                raise AssertionError(f"{dt}: value or gradient not finite")
        # the reductions run in a fixed order: two value+grads on the same
        # inputs agree bit for bit
        same = first[0] == out[0] and np.array_equal(first[1], out[1]) \
            and np.array_equal(first[2], out[2])
        if not same:
            raise AssertionError(f"{dt}: value+grad not bit-reproducible: "
                                 f"{first} then {out}")
        name = str(dt).split(".")[-1]
        res[name] = dict(scalar=first, vector=vec, first_s=first_s,
                         value_grad_ms=statistics.median(times),
                         bit_equal=same)
        log(f"  cuda {name}: loglik {first[0]!r}, dcovparms {first[1]}, "
            f"dnugget {float(first[2])!r}; vector nuggets: loglik "
            f"{vec[0]!r}, dcovparms {vec[1]}, |dnuggets|max "
            f"{np.abs(vec[2]).max():.6e}")
        log(f"  cuda {name}: first value+grad {first_s:.2f} s, median "
            f"value+grad {res[name]['value_grad_ms']:.2f} ms over 5")
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches during the gradient phase: {launches}; H9's plain "
        f"version front_factor_vjp ran "
        f"{_launches(('front_factor_vjp',))['front_factor_vjp']} times")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the gradient path never "
                             f"launched: {launches}")
    if _launches(("front_factor_vjp",))["front_factor_vjp"]:
        raise AssertionError("the card's gradient ran H9's plain version")
    if big:
        return res, launches, peak

    fn = gt.loglik_fn(spec, device="cpu", dtype=torch.float64)
    zt = torch.as_tensor(z, dtype=torch.float64)
    t0 = time.perf_counter()
    cpu = dict(scalar=value_grad(fn, zt, NUGGET),
               vector=value_grad(fn, zt, nvec))
    log(f"  cpu float64 plain path: value+grad twice in "
        f"{time.perf_counter() - t0:.1f} s")
    ok = True
    for case in ("scalar", "vector"):
        ref, g64, g32 = (cpu[case], res["float64"][case],
                         res["float32"][case])
        scale = max(np.abs(ref[1]).max(), np.abs(ref[2]).max())
        e64 = max(np.abs(g64[i] - ref[i]).max() for i in (1, 2)) / scale
        e32 = max(np.abs(g32[i] - g64[i]).max() / np.abs(g64[i]).max()
                  for i in (1, 2))
        log(f"  {case} nuggets: grad cuda f64 vs cpu f64 {e64:.3e} of "
            f"|g|max (tol {GRAD_F64_REL:g}); cuda f32 vs cuda f64 "
            f"{e32:.3e} of each group's max (tol {GRAD_F32_REL:g})")
        ok = ok and e64 <= GRAD_F64_REL and e32 <= GRAD_F32_REL
    if not ok:
        raise AssertionError("gradient: the card disagrees with the "
                             "reference path")
    return res, launches, peak


def _exp05(dist, covparms):
    """The Matern at smoothness 0.5 as a user callable (H8's path)."""
    return covparms[0] * torch.exp(-dist / covparms[1])


def cov_layer_ms(spec, dt):
    """(build, build + VJP) milliseconds of the packed smoothness-0.8
    covariance over all row chunks in torch (``build_cov_packed`` through
    ``kernels/bessel.py``): the plain log K_nu layer that the general
    path ran before its covariance moved into H1 and H5, for one
    evaluation and one value+grad (the backward's rebuild and its three
    more log K_nu evaluations), without the solves and the factor.  No
    path of the port runs it on the card now but the general Matern above
    ``max_neighbors``; it is timed as the yardstick of the fused kernels."""
    from gpvecchia_torch.kernels import covariance as CV
    from gpvecchia_torch.kernels import u_entries as UE
    from gpvecchia_torch.plan import get_plan
    plan = get_plan(spec)
    dev = "cuda"
    locs = torch.as_tensor(plan.locs, dtype=dt, device=dev)
    NN, valid, cond = (torch.as_tensor(a, device=dev)
                       for a in (plan.NN, plan.valid, plan.cond))
    nug = torch.full((plan.n_all,), NUGGET, dtype=dt, device=dev)
    cp = torch.tensor(GEN_COVPARMS, dtype=dt, device=dev)
    chunks = UE._row_chunks(NN.shape[0], NN.shape[1], dt)

    def kernel(dist, c):
        return CV.matern(dist, c, CV.GENERAL)

    def build():
        for sl in chunks:
            UE.build_cov_packed(locs, NN[sl], valid[sl], cond[sl], nug,
                                kernel, cp)

    def build_vjp():
        c = cp.clone().requires_grad_(True)
        for sl in chunks:
            Cp = UE.build_cov_packed(locs, NN[sl], valid[sl], cond[sl], nug,
                                     kernel, c)
            torch.autograd.grad(Cp, c, torch.ones_like(Cp))

    return cuda_time(build, 3), cuda_time(build_vjp, 3)


def users_range_check(spec, z, big):
    """The smoothness-0.8 Matern at the range of the JAX package's default
    start (USER_COVPARMS), where float32 drops rows.  Value and gradient on
    the card must be finite in each dtype run.  Over the first row chunk the
    U entries (the general H1) in float32 and float64 must agree on the rows
    that both keep and whose float64 matrix has a condition number <=
    F32_COND_MAX."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.kernels import u_entries as UE
    dev = "cuda"
    res = {}
    for dt in ((torch.float32,) if big else (torch.float64, torch.float32)):
        name = str(dt).split(".")[-1]
        fn = gt.loglik_fn(spec, device=dev, dtype=dt, with_aux=True)
        c = torch.tensor(USER_COVPARMS, dtype=torch.float64,
                         requires_grad=True)
        g = torch.tensor(NUGGET, dtype=torch.float64, requires_grad=True)
        ll, aux = fn(torch.as_tensor(z, dtype=dt, device=dev), c, g)
        dc, dg = torch.autograd.grad(ll, (c, g))
        ll, dropped = float(ll.detach()), int(aux["n_dropped_rows"])
        if not (np.isfinite(ll) and bool(torch.isfinite(dc).all())
                and bool(torch.isfinite(dg))):
            raise AssertionError(f"covparms {USER_COVPARMS} {name}: value or "
                                 f"gradient not finite")
        res[name] = dict(loglik=ll, dcovparms=dc.tolist(), dnugget=float(dg),
                         dropped_rows=dropped)
        log(f"  covparms {USER_COVPARMS} cuda {name}: loglik {ll!r}, "
            f"dcovparms {dc.numpy()}, dnugget {float(dg)!r}; rows dropped "
            f"(not SPD) {dropped}")
    if not big:
        res["value_rel_f32_f64"] = abs(
            res["float32"]["loglik"] - res["float64"]["loglik"]) / abs(
                res["float64"]["loglik"])
        log(f"  value f32 vs f64 {res['value_rel_f32_f64']:.3e} relative (not "
            f"held: a row that f32 drops leaves the value)")

    chunk = _first_chunk(spec, dev)
    well = _cond64(_packed_cov(chunk, USER_COVPARMS),
                   chunk["NN"].shape[1]) <= F32_COND_MAX
    cols = {}
    for dt in (torch.float64, torch.float32):
        col, bad = UE.u_entries(
            chunk["locs"].to(dt), chunk["NN"], chunk["valid"], chunk["cond"],
            chunk["nug"].to(dt), torch.tensor(USER_COVPARMS,
                                              dtype=torch.float64))
        cols[dt] = col.double(), bad
    (c64, b64), (c32, b32) = cols[torch.float64], cols[torch.float32]
    held = ~b64 & ~b32 & well
    rel = ((c32 - c64)[held].abs().max() / c64[held].abs().max()).item()
    res["u_entries"] = dict(rows=len(held), dropped_f64=int(b64.sum()),
                            dropped_f32=int(b32.sum()), held=int(held.sum()),
                            rel=rel)
    log(f"  U entries of the first {len(held)} rows: dropped f64 "
        f"{int(b64.sum())}, f32 {int(b32.sum())}; f32 vs f64 on the "
        f"{int(held.sum())} rows both keep with cond <= {F32_COND_MAX:g}: "
        f"{rel:.3e} of their max (tol {U_F32_REL:g})")
    if not rel <= U_F32_REL:
        raise AssertionError(f"covparms {USER_COVPARMS}: f32 U entries "
                             f"disagree with f64")
    return res


def general_phase(spec, z, big, counters, packed):
    """Value and value+grad at smoothness 0.8 on the card (the general H1
    and H5 with the factor's kernels); returns (results, launches, peak,
    esqe's launches).  Every kernel of ``counters`` must launch in the
    smoothness-0.8 runs and none of ``packed`` (H8, solve_e0_bwd), which
    must launch in esqe's run."""
    import gpvecchia_torch as gt
    _reset(counters + packed)
    torch.cuda.reset_peak_memory_stats()
    res = {}
    for dt in ((torch.float32,) if big else (torch.float64, torch.float32)):
        name = str(dt).split(".")[-1]
        t0 = time.perf_counter()
        ll = gt.vecchia_likelihood(z, spec, GEN_COVPARMS, NUGGET,
                                   device="cuda", dtype=dt)
        first_s = time.perf_counter() - t0
        fn = gt.loglik_fn(spec, device="cuda", dtype=dt)
        fn_aux = gt.loglik_fn(spec, device="cuda", dtype=dt, with_aux=True)
        zt = torch.as_tensor(z, dtype=dt, device="cuda")
        evals = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, aux = fn_aux(zt, GEN_COVPARMS, NUGGET)
            v = float(v)
            evals.append((time.perf_counter() - t0) * 1e3)
        dropped = int(aux["n_dropped_rows"])
        t0 = time.perf_counter()
        first = value_grad(fn, zt, NUGGET, GEN_COVPARMS)
        first_vg_s = time.perf_counter() - t0
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = value_grad(fn, zt, NUGGET, GEN_COVPARMS)
            times.append((time.perf_counter() - t0) * 1e3)
        # a dropped row is a constant of the value (its gradient is 0); at
        # the default size none may drop, at n=1e6 the count is reported
        if not (np.isfinite(ll) and np.all(np.isfinite(first[1]))
                and np.isfinite(float(first[2]))) or (dropped and not big):
            raise AssertionError(f"general {dt}: value or gradient not "
                                 f"finite, or {dropped} rows dropped")
        if abs(v - ll) > 1e-6 * abs(ll) or np.abs(out[1] - first[1]).max() \
                > 1e-6 * np.abs(first[1]).max():
            raise AssertionError(f"general {dt}: not repeatable")
        res[name] = dict(loglik=ll, first_s=first_s,
                         eval_ms=statistics.median(evals),
                         first_value_grad_s=first_vg_s,
                         value_grad_ms=statistics.median(times), grad=first,
                         dropped_rows=dropped)
        log(f"  cuda {name}: loglik {ll!r}, dcovparms {first[1]}, dnugget "
            f"{float(first[2])!r}; rows dropped (not SPD) {dropped}")
        log(f"  cuda {name}: first eval {first_s:.2f} s, median eval "
            f"{res[name]['eval_ms']:.2f} ms; first value+grad "
            f"{first_vg_s:.2f} s, median value+grad "
            f"{res[name]['value_grad_ms']:.2f} ms (5 each)")
    # the counts and the peak of the smoothness-0.8 runs alone: what follows
    # launches the same kernels
    launches = _launches(counters + packed)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches during the smoothness-0.8 runs: {launches}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    if min(_launches(counters).values()) <= 0 or any(
            _launches(packed).values()):
        raise AssertionError(f"the general path did not launch the general "
                             f"H1/H5 and the factor's kernels alone: "
                             f"{launches}")

    build_ms, build_vjp_ms = cov_layer_ms(spec, torch.float32)
    res["cov_build_ms"], res["cov_build_vjp_ms"] = build_ms, build_vjp_ms
    log(f"  float32 log K_nu layer in torch (plain: build_cov_packed, no "
        f"longer on the general path): build {build_ms:.2f} ms, build+VJP "
        f"{build_vjp_ms:.2f} ms")
    res["users_range"] = users_range_check(spec, z, big)
    res["fused_vs_packed"] = fused_vs_packed(spec, z, big)
    res["esqe"], esqe_launches = esqe_run(spec, z, packed)

    if not big:
        zt = torch.as_tensor(z, dtype=torch.float64, device="cuda")
        builtin, callable_ = (value_grad(gt.loglik_fn(spec, cm, device="cuda"),
                                         zt, NUGGET)
                              for cm in ("matern", _exp05))
        scale = max(np.abs(builtin[1][:2]).max(), abs(float(builtin[2])))
        e_val = abs(callable_[0] - builtin[0]) / abs(builtin[0])
        e_grad = max(np.abs(callable_[1][:2] - builtin[1][:2]).max(),
                     abs(float(callable_[2]) - float(builtin[2]))) / scale
        res["cross_path"] = dict(value_rel=e_val, grad_rel=e_grad)
        log(f"  nu=0.5 callable (H8) vs built-in matern (H1), f64: value "
            f"{e_val:.3e}, gradient {e_grad:.3e} of |g|max (tol "
            f"{CROSS_REL:g})")
        if not (e_val <= CROSS_REL and e_grad <= CROSS_REL):
            raise AssertionError("the H8 path disagrees with the H1 path")
    if big:
        return res, launches, peak, esqe_launches

    fn = gt.loglik_fn(spec, device="cpu", dtype=torch.float64)
    t0 = time.perf_counter()
    cpu = value_grad(fn, torch.as_tensor(z, dtype=torch.float64), NUGGET,
                     GEN_COVPARMS)
    log(f"  cpu float64 plain path: loglik {cpu[0]!r}, value+grad "
        f"{time.perf_counter() - t0:.1f} s")
    g64, g32 = res["float64"], res["float32"]
    pair = slice(0, 2)
    scale = max(np.abs(cpu[1][pair]).max(), abs(float(cpu[2])))
    err = dict(
        value64=abs(g64["loglik"] - cpu[0]) / abs(cpu[0]),
        grad64=max(np.abs(g64["grad"][1][pair] - cpu[1][pair]).max(),
                   abs(float(g64["grad"][2]) - float(cpu[2]))) / scale,
        dnu64=abs(g64["grad"][1][2] - cpu[1][2]) / abs(cpu[1][2]),
        value32=abs(g32["loglik"] - g64["loglik"]) / abs(g64["loglik"]),
        pair32=np.abs(g32["grad"][1][pair] - g64["grad"][1][pair]).max()
        / np.abs(g64["grad"][1][pair]).max(),
        dnu32=abs(g32["grad"][1][2] - g64["grad"][1][2])
        / abs(g64["grad"][1][2]),
        nug32=abs(float(g32["grad"][2]) - float(g64["grad"][2]))
        / abs(float(g64["grad"][2])))
    tol = dict(value64=GEN_F64_REL, grad64=GEN_F64_REL, dnu64=GEN_DNU_F64_REL,
               value32=SLICE_F32_REL, pair32=GEN_F32_PAIR, dnu32=GEN_F32_DNU,
               nug32=GEN_F32_NUG)
    res["errors"] = err
    log("  general vs reference: " + ", ".join(
        f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in err.items()))
    if any(err[k] > tol[k] for k in tol):
        raise AssertionError("general phase: the card disagrees with the "
                             "reference path")
    return res, launches, peak, esqe_launches


ESQE_COVPARMS = (0.8, 0.3, 0.4, 0.2)


def esqe_run(spec, z, packed):
    """esqe's value and gradient in float32 on the card: the packed path.
    The launch counts of ``packed`` (H8, solve_e0_bwd) are set to 0 just
    before and read just after; each must be positive."""
    import gpvecchia_torch as gt
    _reset(packed)
    fn = gt.loglik_fn(spec, "esqe", device="cuda", dtype=torch.float32)
    r = value_grad(fn, torch.as_tensor(z, dtype=torch.float32,
                                       device="cuda"), NUGGET, ESQE_COVPARMS)
    launches = _launches(packed)
    log(f"  esqe {ESQE_COVPARMS} f32: loglik {r[0]!r}, dcovparms {r[1]}, "
        f"dnugget {float(r[2])!r}; launches {launches}")
    if not (np.isfinite(r[0]) and np.all(np.isfinite(r[1]))):
        raise AssertionError("esqe: value or gradient not finite")
    if min(launches.values()) <= 0:
        raise AssertionError(f"esqe did not launch H8 and solve_e0_bwd: "
                             f"{launches}")
    return _jsonable(r), launches


def _matern_callable(dist, covparms):
    """The built-in Matern passed as a user callable: the packed path
    (build_cov_packed, H8, solve_e0_bwd)."""
    from gpvecchia_torch.kernels import covariance as CV
    return CV.matern(dist, covparms)


# fused vs packed in float32 beyond smoothness 0.8: 1.4995 (float32's
# climb to nu + h differs from float64's there, see GEN_NUS) and 2.0, at a
# range of FVP_SPACING / sqrt(n), about the points' spacing, where float32
# drops no row (at range 0.05 the plain float32 path drops 318 and 13 316 of
# the 1e5 rows of m=20 at these smoothnesses, on the CPU)
FVP_NUS = (1.4995, 2.0)
FVP_SPACING = 1.0


def _route_vg(spec, cm, zt, covparms):
    """Value, gradient and dropped rows of covariance model ``cm`` on the
    card, in zt's dtype."""
    import gpvecchia_torch as gt
    fn = gt.loglik_fn(spec, cm, device="cuda", dtype=zt.dtype,
                      with_aux=True)
    c = torch.tensor(covparms, dtype=torch.float64, requires_grad=True)
    g = torch.tensor(NUGGET, dtype=torch.float64, requires_grad=True)
    ll, aux = fn(zt, c, g)
    dc, dg = torch.autograd.grad(ll, (c, g))
    return dict(loglik=float(ll.detach()), dcovparms=dc.tolist(),
                dnugget=float(dg), dropped_rows=int(aux["n_dropped_rows"]))


def fused_vs_packed(spec, z, big):
    """The Matern by its two independent routes on the card: the built-in
    'matern' (log K_nu inside the general H1 and H5) and the same Matern
    as a user callable (the torch build, H8, solve_e0_bwd).  Value and
    gradient held at smoothness 0.8, range 0.05: in float64 at the default
    size (value GEN_F64_REL, (sig2, rho, nugget) GRAD_F64_REL of |g|max,
    d/dnu GEN_DNU_F64_REL relative), in float32 at n > 1e5 (value
    SLICE_F32_REL, (sig2, rho) GEN_F32_PAIR of their max, d/dnu GEN_F32_DNU
    relative, the nugget GEN_F32_NUG); in float32 by the same tolerances at
    FVP_NUS at both sizes.  The rows each route drops in float32 at ranges
    0.05 and 0.2 are reported."""
    res = {}
    routes = (("fused", "matern"), ("packed", _matern_callable))
    for dt in ((torch.float32,) if big else (torch.float64, torch.float32)):
        name = str(dt).split(".")[-1]
        zt = torch.as_tensor(z, dtype=dt, device="cuda")
        ranges = (GEN_COVPARMS[1],) + (
            (USER_COVPARMS[1],) if dt == torch.float32 else ())
        for rho in ranges:
            out = {route: _route_vg(spec, cm, zt, (1.0, rho, 0.8))
                   for route, cm in routes}
            res[f"{name} range {rho}"] = out
            log(f"  fused vs packed, {name}, range {rho}: loglik "
                f"{out['fused']['loglik']!r} / {out['packed']['loglik']!r}, "
                f"rows dropped {out['fused']['dropped_rows']} / "
                f"{out['packed']['dropped_rows']}")
    held = ("float32" if big else "float64", GEN_COVPARMS[1], 0.8)
    zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")
    rho = FVP_SPACING / len(z) ** 0.5
    for nu in FVP_NUS:
        res[f"float32 range {rho:.4g} nu {nu}"] = {
            route: _route_vg(spec, cm, zt, (1.0, rho, nu))
            for route, cm in routes}
    failed = False
    for key in [f"{held[0]} range {held[1]}"] + [
            f"float32 range {rho:.4g} nu {nu}" for nu in FVP_NUS]:
        a, b = res[key]["fused"], res[key]["packed"]
        ga, gb = (np.array(r["dcovparms"] + [r["dnugget"]]) for r in (a, b))
        err = dict(value=abs(a["loglik"] - b["loglik"]) / abs(b["loglik"]),
                   dnu=abs(ga[2] - gb[2]) / abs(gb[2]))
        if key.startswith("float64"):
            keep = [0, 1, 3]
            err["grad"] = np.abs(ga[keep] - gb[keep]).max() \
                / np.abs(gb[keep]).max()
            tol = dict(value=GEN_F64_REL, dnu=GEN_DNU_F64_REL,
                       grad=GRAD_F64_REL)
        else:
            err["pair"] = np.abs(ga[:2] - gb[:2]).max() \
                / np.abs(gb[:2]).max()
            err["nugget"] = abs(ga[3] - gb[3]) / abs(gb[3])
            tol = dict(value=SLICE_F32_REL, dnu=GEN_F32_DNU,
                       pair=GEN_F32_PAIR, nugget=GEN_F32_NUG)
        res[key]["errors"] = {k: float(v) for k, v in err.items()}
        log(f"  fused vs packed ({key}; d/dnu {float(ga[2])!r} / "
            f"{float(gb[2])!r}, rows "
            f"dropped {a['dropped_rows']} / {b['dropped_rows']}): "
            + ", ".join(f"{k} {v:.3e} (tol {tol[k]:g})"
                        for k, v in err.items()))
        failed = failed or not all(err[k] <= tol[k] for k in tol)
    if failed:
        raise AssertionError("the fused general path disagrees with the "
                             "packed path")
    return res


def _obj_grad_ms(spec, z, lg, dt):
    """Median ms of one estimation objective+gradient on the card."""
    from gpvecchia_torch.fit import mle
    obj = mle.neg_loglik_fn(spec, z, len(lg), device="cuda", dtype=dt)

    def once():
        lgt = torch.tensor(lg, dtype=torch.float64, requires_grad=True)
        v = obj(lgt)
        (g,) = torch.autograd.grad(v, lgt)
        return float(v.detach()), g.numpy()

    once()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def estimate_phase(locs, z, m, big, seed):
    """L-BFGS-B estimation on the card (f32) on this run's data plus a
    constant trend; at the default size also a dense-GP check at n=2000:
    the card's estimate (f64) reaches the CPU's log-likelihood."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.fit import mle
    from scipy.spatial.distance import cdist
    res = {}
    max_iter = 3 if big else 5
    t0 = time.perf_counter()
    est = gt.vecchia_estimate(z + 1.0, locs, m=m, max_iter=max_iter,
                              output_level=0, device="cuda",
                              dtype=torch.float32)
    total_s = time.perf_counter() - t0
    lg0 = np.log(mle._theta_ini(est["z"], locs))
    step_ms = _obj_grad_ms(est["spec"], est["z"], lg0, torch.float32)
    if not (np.isfinite(est["loglik"]) and np.isfinite(est["theta_hat"]).all()):
        raise AssertionError("estimate: not finite")
    res["run"] = dict(n_iter=est["n_iter"], theta_hat=est["theta_hat"].tolist(),
                      loglik=est["loglik"], total_s=total_s,
                      obj_grad_ms=step_ms, max_iter=max_iter)
    log(f"  lbfgs f32 (max_iter {max_iter}): n_iter {est['n_iter']}, "
        f"converged {est['converged']}, theta_hat {est['theta_hat']}, "
        f"loglik {est['loglik']!r}, "
        f"{total_s:.1f} s in all (spec included); one objective+gradient "
        f"{step_ms:.2f} ms")
    if big:
        return res
    res["f32_vs_f64"] = dtype_estimates(locs, z, m)
    rng = np.random.default_rng(seed + 1)
    n2 = 2000
    locs2 = rng.uniform(size=(n2, 2))
    K = 2.0 * np.exp(-cdist(locs2, locs2) / 0.2) + 0.2 * np.eye(n2)
    y = np.linalg.cholesky(K) @ rng.normal(size=n2) + 1.0
    ests = {dev: gt.vecchia_estimate(y, locs2, m=10, max_iter=10,
                                     output_level=0, device=dev)
            for dev in ("cuda", "cpu")}
    rel = abs(ests["cuda"]["loglik"] - ests["cpu"]["loglik"]) / abs(
        ests["cpu"]["loglik"])
    res["dense_n2000"] = dict(
        cuda=dict(theta_hat=ests["cuda"]["theta_hat"].tolist(),
                  loglik=ests["cuda"]["loglik"]),
        cpu=dict(theta_hat=ests["cpu"]["theta_hat"].tolist(),
                 loglik=ests["cpu"]["loglik"]), rel=rel)
    log(f"  dense GP n={n2}, f64, lbfgs 10: cuda loglik "
        f"{ests['cuda']['loglik']!r} theta {ests['cuda']['theta_hat']}; cpu "
        f"loglik {ests['cpu']['loglik']!r}; rel {rel:.3e} (tol {EST_REL:g})")
    if rel > EST_REL:
        raise AssertionError("estimate: the card's estimate disagrees with "
                             "the CPU's")
    return res


def dtype_estimates(locs, z, m):
    """``vecchia_estimate`` (L-BFGS-B, its default start and iteration
    limit) on this run's data plus a constant trend in float32 and in
    float64 on the card: theta_hat, iterations and the rows each drops (not
    SPD) at the start and at its estimate.  A measurement: nothing is held
    but finiteness."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.fit import mle
    out = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        t0 = time.perf_counter()
        est = gt.vecchia_estimate(z + 1.0, locs, m=m, output_level=0,
                                  device="cuda", dtype=dt)
        total_s = time.perf_counter() - t0
        fn = gt.loglik_fn(est["spec"], device="cuda", dtype=dt, with_aux=True)
        zt = torch.as_tensor(est["z"], dtype=dt, device="cuda")
        dropped = {}
        for at, th in (("start", mle._theta_ini(est["z"], locs)),
                       ("estimate", est["theta_hat"])):
            _, aux = fn(zt, th[:3], float(th[3]))
            dropped[at] = int(aux["n_dropped_rows"])
        if not np.isfinite(est["theta_hat"]).all():
            raise AssertionError(f"estimate {name}: not finite")
        out[name] = dict(theta_hat=est["theta_hat"].tolist(),
                         n_iter=int(est["n_iter"]),
                         converged=est["converged"], loglik=est["loglik"],
                         dropped_rows=dropped, total_s=total_s)
        log(f"  lbfgs {name} to convergence: n_iter {est['n_iter']}, "
            f"converged {est['converged']}, theta_hat {est['theta_hat']}, "
            f"loglik {est['loglik']!r}, rows dropped at the start "
            f"{dropped['start']} and at the estimate {dropped['estimate']}, "
            f"{total_s:.1f} s")
    return out


PRED_KEYS = ("mu_obs", "mu_pred", "var_obs", "var_pred")


def _pred_errors(got, ref):
    """Each output's max |got - ref| over its max |ref| (outputs not
    computed, None, skipped)."""
    return {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in PRED_KEYS if ref[k] is not None and ref[k].size}


def _check_pred(label, out, spec):
    """Finite means and positive finite variances of the expected shapes
    (outputs not computed, None, skipped)."""
    for k in PRED_KEYS:
        size = spec.n_obs if k.endswith("obs") else spec.n_pred
        v = out[k]
        if v is None:
            continue
        if v.shape != (size,) or not np.all(np.isfinite(v)) or (
                k.startswith("var") and not np.all(v > 0)):
            raise AssertionError(f"{label}: {k} of shape {v.shape} not "
                                 f"({size},), not finite or not positive")


def _drop_f64_caches(spec):
    """Drop the f64 device arrays and functions cached in the plan."""
    from gpvecchia_torch.plan import get_plan
    cache = get_plan(spec).cache
    for k in [k for k in cache if isinstance(k, tuple)
              and torch.float64 in k]:
        del cache[k]
    torch.cuda.empty_cache()


def cost_posterior(mf, dt):
    """{"backsub" | "selinv": (bytes, operations)} on a kept factor of the
    plan ``mf``: each level's L_pp lower triangle and L_bp read once and x
    (the diagonal) written once; the operations of the back-substitution
    (triangular solve, border product) and of the selected inverse
    (L_pp^{-1}, the symmetric L_pp^{-T} L_pp^{-1}, G = L_bp L_pp^{-1},
    S_bb G, the symmetric G^T S_bp; at the leaf the diagonals alone)."""
    size = _size(dt)
    out = {"backsub": [mf.n_vert * size, 0.0],
           "selinv": [mf.n_vert * size, 0.0]}
    for d, lv in enumerate(mf.levels):
        N, P, B = lv.piv_ids.shape[0], lv.npiv, lv.nbord
        read = N * (P * (P + 1) // 2 + B * P) * size
        leaf = d == mf.depth and B > 0 and d > 0
        tail = (P * P + 2 * B * P) if leaf else (P ** 3 / 3 + B * P * P)
        out["backsub"][0] += read
        out["backsub"][1] += N * (P * P + 2 * B * P)
        out["selinv"][0] += read
        out["selinv"][1] += N * (P ** 3 / 3 + B * P * P + 2 * B * B * P
                                 + tail)
    return {k: tuple(v) for k, v in out.items()}


def pred_run(spec, z, big, counters, label):
    """Posterior prediction on the card through ``vecchia_prediction`` (f32;
    at the default size f64 too), then, through the cached functions it
    runs, the mean (factor kept, back-substitution) and the selected
    inverse on that factor timed apart: median of 5, warm (bench.py cfg2's
    ``pred_mean_ms`` and ``pred_selinv_ms``), and the back-substitution
    alone, the last two beside their bounds (``cost_posterior``: plain
    torch, no hand kernel, so in no ``kernels`` row).  The counts of
    ``counters``
    are set to 0 first and each must be positive at the end.  Then the
    checks: at the default size f64 on the card against the CPU plain path
    and f32 against f64; at n > 1e5 f32 against one f64 run on the card."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.inference.prediction import _pred_fns
    from gpvecchia_torch.linalg.multifrontal import mf_backward
    from gpvecchia_torch.plan import get_mf_plan, get_plan
    mf, _ = get_mf_plan(get_plan(spec))
    _reset(counters)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, outs = {}, {}
    for dt in ((torch.float32,) if big else (torch.float64, torch.float32)):
        name = str(dt).split(".")[-1]
        t0 = time.perf_counter()
        out = gt.vecchia_prediction(z, spec, COVPARMS, NUGGET, device="cuda",
                                    dtype=dt)
        first_s = time.perf_counter() - t0
        del out["V"], out["_plan"]
        _check_pred(f"{label} {name}", out, spec)
        outs[name] = out
        (mean_fn, var_fn), _ = _pred_fns(spec, "matern",
                                         torch.device("cuda"), dt)
        zt = torch.as_tensor(z, dtype=dt, device="cuda")
        t_mean, t_var, t_bs = [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mu, fac = mean_fn(zt, COVPARMS, NUGGET)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            d = var_fn(fac)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with torch.no_grad():
                mf_backward(fac)
            torch.cuda.synchronize()
            t_mean.append((t1 - t0) * 1e3)
            t_var.append((t2 - t1) * 1e3)
            t_bs.append((time.perf_counter() - t2) * 1e3)
            del mu, fac, d
        costs = cost_posterior(mf, dt)
        res[name] = dict(first_s=first_s,
                         pred_mean_ms=statistics.median(t_mean),
                         pred_selinv_ms=statistics.median(t_var),
                         backsub_ms=statistics.median(t_bs))
        for part in ("backsub", "selinv"):
            res[name][part + "_bound_ms"], res[name][part + "_bound_by"] = \
                _bound(*costs[part], dt)
        r = res[name]
        log(f"  cuda {name}: vecchia_prediction first call {first_s:.2f} s; "
            f"mean {r['pred_mean_ms']:.2f} ms, selected inverse "
            f"{r['pred_selinv_ms']:.2f} ms (bound {r['selinv_bound_ms']:.3f} "
            f"by {r['selinv_bound_by']}), the mean's back-substitution "
            f"alone {r['backsub_ms']:.2f} ms (bound {r['backsub_bound_ms']:.3f} "
            f"by {r['backsub_bound_by']}) (medians of 5)")
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()
    res.update(launches=launches, peak_bytes=peak, base_bytes=base)
    log(f"  launches: {launches}; peak device memory {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} above the phase's start)")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{label}: a kernel of the prediction path "
                             f"never launched: {launches}")
    if big:
        ref = gt.vecchia_prediction(z, spec, COVPARMS, NUGGET, device="cuda",
                                    dtype=torch.float64,
                                    return_values="meanvar")
        _check_pred(f"{label} float64", ref, spec)
        outs["float64"] = ref
        _drop_f64_caches(spec)
    else:
        t0 = time.perf_counter()
        cpu = gt.vecchia_prediction(z, spec, COVPARMS, NUGGET, device="cpu",
                                    return_values="meanvar")
        e64 = _pred_errors(outs["float64"], cpu)
        res["f64_vs_cpu"] = e64
        log(f"  cpu float64 plain path ({time.perf_counter() - t0:.1f} s); "
            f"cuda f64 vs cpu f64: "
            + ", ".join(f"{k} {v:.3e}" for k, v in e64.items())
            + f" (tol {PRED_F64_REL:g})")
        if max(e64.values()) > PRED_F64_REL:
            raise AssertionError(f"{label}: the card's f64 prediction "
                                 "disagrees with the CPU's")
    e32 = _pred_errors(outs["float32"], outs["float64"])
    res["f32_vs_f64"] = e32
    log(f"  cuda f32 vs cuda f64: "
        + ", ".join(f"{k} {v:.3e}" for k, v in e32.items())
        + f" (tol {PRED_F32_REL:g})")
    if max(e32.values()) > PRED_F32_REL:
        raise AssertionError(f"{label}: f32 prediction disagrees with f64")
    return res


def pred_phase(spec, locs, z, big, counters, locs_pred):
    """``pred_run`` on this run's spec and, at the default size, on an SGV
    spec of the same points with ``locs_pred`` in the general ordering."""
    import gpvecchia_torch as gt
    log(f"  SGV spec of the run (n={spec.n_obs}, m={spec.m}):")
    res = {"spec": pred_run(spec, z, big, counters, "prediction")}
    if not big:
        t0 = time.perf_counter()
        spec_p = gt.vecchia_specify(locs, m=spec.m, cond_yz="SGV",
                                    locs_pred=locs_pred,
                                    ordering_pred="general")
        log(f"  SGV spec with {locs_pred.shape[0]} prediction points, "
            f"general ordering ({time.perf_counter() - t0:.1f} s):")
        res["pred_points"] = pred_run(spec_p, z, big, counters,
                                      "prediction points")
    return res


def vl_phase(spec, locs, zb, big, counters):
    """Vecchia-Laplace, logistic, on Bernoulli(0.5) data (bench.py cfg4):
    ``calculate_posterior_VL`` in f32 on the card, max_iter VL_MAX_ITER,
    once warm and then 3 times (``vl_nr_ms`` the median of their runtime;
    ``vl_iters``, ``vl_iter_ms``, ``vl_cnvgd``), with the counts of
    ``counters`` set to 0 first and each positive after those runs; once
    in f64 at the same size (reported).  Then f64 on the card against the
    CPU plain path on an SGV spec of the first VL_CHECK_N points, m =
    VL_CHECK_M."""
    import gpvecchia_torch as gt
    _reset(counters)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kw = dict(max_iter=VL_MAX_ITER, device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    gt.calculate_posterior_VL(zb, spec, "logistic", COVPARMS, **kw)
    first_s = time.perf_counter() - t0
    runs = [gt.calculate_posterior_VL(zb, spec, "logistic", COVPARMS, **kw)
            for _ in range(3)]
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()
    iters = runs[0]["iter"]
    for r in runs:
        if r["iter"] != iters or r["mean"].shape != zb.shape \
                or not np.all(np.isfinite(r["mean"])):
            raise AssertionError("VL: mean not finite or runs differ")
    nr_ms = statistics.median(r["runtime"] * 1e3 for r in runs)
    res = dict(vl_nr_ms=nr_ms, vl_iters=iters,
               vl_iter_ms=nr_ms / max(iters, 1), vl_cnvgd=runs[0]["cnvgd"],
               first_s=first_s, launches=launches, peak_bytes=peak,
               base_bytes=base)
    log(f"  cuda float32: first call {first_s:.2f} s; NR solve "
        f"{nr_ms:.2f} ms (median of 3), {iters} iterations "
        f"({res['vl_iter_ms']:.2f} ms each), converged {res['vl_cnvgd']}")
    log(f"  launches: {launches}; peak device memory {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} above the phase's start)")
    if min(launches.values()) <= 0:
        raise AssertionError(f"VL: a kernel of the NR path never launched: "
                             f"{launches}")
    # f64 at the same size, once: its iterations and convergence beside
    # f32's (reported), and how far f32's mean lies from it
    p64 = gt.calculate_posterior_VL(zb, spec, "logistic", COVPARMS,
                                    max_iter=VL_MAX_ITER, device="cuda")
    res["float64"] = dict(
        runtime_ms=p64["runtime"] * 1e3, iters=p64["iter"],
        cnvgd=p64["cnvgd"], f32_mean_vs_f64=float(
            np.abs(runs[0]["mean"] - p64["mean"]).max()
            / np.abs(p64["mean"]).max()))
    log(f"  cuda float64 once: {res['float64']['runtime_ms']:.2f} ms, "
        f"{p64['iter']} iterations, converged {p64['cnvgd']}; f32 mean vs "
        f"f64 {res['float64']['f32_mean_vs_f64']:.3e} of its max "
        "(reported)")
    del p64
    nc = min(VL_CHECK_N, zb.size)
    t0 = time.perf_counter()
    sub = gt.vecchia_specify(locs[:nc], m=VL_CHECK_M, cond_yz="SGV")
    post = {dev: gt.calculate_posterior_VL(
        zb[:nc], sub, "logistic", COVPARMS, max_iter=VL_MAX_ITER, device=dev)
        for dev in ("cuda", "cpu")}
    errs = {k: float(np.abs(post["cuda"][k] - post["cpu"][k]).max()
                     / np.abs(post["cpu"][k]).max()) for k in ("mean", "D")}
    same = [(p["iter"], p["cnvgd"]) for p in post.values()]
    res["check"] = dict(n=nc, m=VL_CHECK_M, errors=errs,
                        iter=post["cpu"]["iter"], cnvgd=post["cpu"]["cnvgd"])
    log(f"  n={nc}, m={VL_CHECK_M}, f64 ({time.perf_counter() - t0:.1f} s): "
        f"(iterations, converged) cuda {same[0]}, cpu {same[1]}; cuda vs "
        f"cpu mean {errs['mean']:.3e}, D {errs['D']:.3e} (tol "
        f"{VL_F64_REL:g})")
    if same[0] != same[1] or max(errs.values()) > VL_F64_REL:
        raise AssertionError("VL: the card's f64 solve disagrees with the "
                             "CPU's")
    return res


def _count(name):
    """The count of ``name`` in the port's trace table (0 if absent)."""
    from gpvecchia_torch.utils import trace
    return trace.table().get(name, {"count": 0})["count"]


# the launch counts of the kernels at the point ``_reset`` last marked them
_LAUNCH_BASE = {}


def _reset(kernels):
    """Count the launches of ``kernels`` (names) afresh from here: the
    trace table sums them over the process."""
    for k in kernels:
        _LAUNCH_BASE[k] = _count(f"launches.{k}")


def _launches(kernels):
    """{kernel: its launches since ``_reset``}."""
    return {k: _count(f"launches.{k}") - _LAUNCH_BASE.get(k, 0)
            for k in kernels}


def _require(label, launches):
    if min(launches.values()) <= 0:
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")


def mra_spec(locs, m, conditioning="mra"):
    """(spec, seconds): ``vecchia_specify`` with MRA conditioning, its
    seconds split into the maxmin ordering, the native knot tree
    (``host.mra_tree``) and the rest (the rows' expansion, the spec's
    arrays), by timing those two functions where the spec calls them."""
    import gpvecchia_torch as gt
    import gpvecchia_torch.spec as S
    from gpvecchia_torch.csrc import host
    secs = {"ordering": 0.0, "mra_tree": 0.0}
    saved = S.order_maxmin_exact, host.mra_tree

    def timed(name, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                secs[name] += time.perf_counter() - t0
        return wrap

    S.order_maxmin_exact = timed("ordering", saved[0])
    host.mra_tree = timed("mra_tree", saved[1])
    try:
        t0 = time.perf_counter()
        spec = gt.vecchia_specify(locs, m=m, conditioning=conditioning)
        total = time.perf_counter() - t0
    finally:
        S.order_maxmin_exact, host.mra_tree = saved
    secs["rest"] = total - secs["ordering"] - secs["mra_tree"]
    secs["total"] = total
    return spec, secs


def _plan_shape(spec):
    """(plan, seconds, {eff_m, depth, leaf F1, root P, levels}) of the
    spec's multifrontal plan."""
    from gpvecchia_torch.plan import get_mf_plan, get_plan
    t0 = time.perf_counter()
    mf, _ = get_mf_plan(get_plan(spec))
    plan_s = time.perf_counter() - t0
    leaf = mf.levels[-1]
    return mf, plan_s, dict(
        eff_m=spec.m, depth=mf.depth, leaf_fronts=int(leaf.piv_ids.shape[0]),
        leaf_F1=int(leaf.npiv + leaf.nbord + 1),
        root_P=int(mf.levels[0].npiv),
        levels=[(int(lv.piv_ids.shape[0]), int(lv.npiv), int(lv.nbord))
                for lv in mf.levels])


def _hold_value_grad(label, spec, z, big, res):
    """The f32 value and gradient on the card (``res["grad"]``) against one
    f64 value+grad on the card: value SLICE_F32_REL relative, gradient
    GRAD_F32_REL of each group's max (dcovparms; dnugget); and at the
    default size the f64 one against the CPU plain path: value
    SLICE_F64_REL relative, gradient GRAD_F64_REL of the reference's
    |g|max.  The f64 run's device arrays are dropped after it."""
    import gpvecchia_torch as gt
    f64 = torch.float64
    g64 = value_grad(gt.loglik_fn(spec, device="cuda", dtype=f64),
                     torch.as_tensor(z, dtype=f64, device="cuda"), NUGGET)
    g32 = res["grad"]
    r32 = abs(g32[0] - g64[0]) / abs(g64[0])
    e32 = max(np.abs(g32[i] - g64[i]).max() / np.abs(g64[i]).max()
              for i in (1, 2))
    res.update(float64=g64[0], rel_f32_f64=r32, grad_f32_f64=e32)
    _drop_f64_caches(spec)
    line = (f"  {label}: cuda f64 loglik {g64[0]!r}, dcovparms {g64[1]}, "
            f"dnugget {float(g64[2])!r}; f32 vs f64: value {r32:.3e} (tol "
            f"{SLICE_F32_REL:g}), gradient {e32:.3e} of each group's max "
            f"(tol {GRAD_F32_REL:g})")
    ok = r32 <= SLICE_F32_REL and e32 <= GRAD_F32_REL
    if not big:
        t0 = time.perf_counter()
        cpu = value_grad(gt.loglik_fn(spec, device="cpu", dtype=f64),
                         torch.as_tensor(z, dtype=f64), NUGGET)
        r64 = abs(g64[0] - cpu[0]) / abs(cpu[0])
        scale = max(np.abs(cpu[1]).max(), np.abs(cpu[2]).max())
        e64 = max(np.abs(g64[i] - cpu[i]).max() for i in (1, 2)) / scale
        res.update(cpu_float64=cpu[0], rel_f64_cpu=r64, grad_f64_cpu=e64)
        line += (f"; cuda f64 vs cpu f64 value+grad "
                 f"({time.perf_counter() - t0:.1f} s): value {r64:.3e} (tol "
                 f"{SLICE_F64_REL:g}), gradient {e64:.3e} of |g|max (tol "
                 f"{GRAD_F64_REL:g})")
        ok = ok and r64 <= SLICE_F64_REL and e64 <= GRAD_F64_REL
    log(line)
    if not ok:
        raise AssertionError(f"{label}: the card disagrees with the "
                             "reference path")
    res["grad"] = _jsonable(g32)


def _plan_kernel_checks(label, mf, dev, seed):
    """H2 and H7 at the plan's leaf, H3 at each internal level and H4 at
    each level with pivots, against their plain versions on the card, as
    for the SGV spec's plan (``leaf_phase``, ``eadd_level_phase``,
    ``h4_level_phase``).  Returns H3's and H4's f32 times summed over the
    levels."""
    log(f"  {label} plan: H2, H7 at its leaf, H3, H4 at its levels against "
        f"their plain versions:")
    leaf_phase(mf, seed, dev)
    _, sums, _, _ = eadd_level_phase(mf, dev, seed, h6=False)
    rows, _ = h4_level_phase([s for s in _level_shapes(mf) if s[2] > 0],
                             dev, seed)
    h4 = [r for r in rows if r["dtype"] == "float32"]
    return dict(extend_add_f32=sums.get("float32"),
                front_factor_f32=dict(levels=len(h4),
                                      ms=sum(r["ms"] for r in h4),
                                      bound_ms=sum(r["bound_ms"]
                                                   for r in h4)))


def mra_phase(locs, z, m, big, counters, bwd_counters, dev, seed):
    """MRA conditioning at this run's n and m (bench.py cfg5): the spec's
    seconds split (``mra_spec``), the plan's shape, H2-H4 and H7 at the
    plan's shapes against their plain versions (``_plan_kernel_checks``),
    ``mra_eval_ms`` (f32, warm, median of 3 at covparms (1.0 + 0.01k, 0.2,
    0.5), nugget 0.1, synchronized) with the counts of ``counters``
    (H1-H4) set to 0 just before the evaluations and read just after,
    value+grad in f32 (median of 3, rows dropped, peak) with H1-H7 counted
    alike, and the value and gradient held (``_hold_value_grad``).  At the
    default size also a 'firstm' spec (every front's border carries the
    first m knots), checked and held alike.  Returns (spec, results)."""
    import gpvecchia_torch as gt
    spec, secs = mra_spec(locs, m)
    mf, plan_s, shape = _plan_shape(spec)
    log(f"  spec {secs['total']:.2f} s (maxmin ordering {secs['ordering']:.2f}"
        f", mra_tree {secs['mra_tree']:.2f}, rest {secs['rest']:.2f}); "
        f"plan {plan_s:.2f} s; eff_m {shape['eff_m']}, MF depth "
        f"{shape['depth']}, leaf {shape['leaf_fronts']} fronts of F1 "
        f"{shape['leaf_F1']}, root P {shape['root_P']}")
    log(f"  levels (fronts, pivots, border): {shape['levels']}")
    res = dict(mra_spec_s=secs["total"], spec_split_s=secs, plan_s=plan_s,
               **shape)
    res["plan_kernels"] = _plan_kernel_checks("MRA", mf, dev, seed)
    del mf
    dt = torch.float32
    zt = torch.as_tensor(z, dtype=dt, device="cuda")
    _reset(counters + bwd_counters)
    torch.cuda.reset_peak_memory_stats()
    fn = gt.loglik_fn(spec, device="cuda", dtype=dt, with_aux=True)
    t0 = time.perf_counter()
    ll, aux = fn(zt, COVPARMS, NUGGET)
    ll, dropped = float(ll), int(aux["n_dropped_rows"])
    first_s = time.perf_counter() - t0
    times = []
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(fn(zt, (1.0 + 0.01 * k, 0.2, 0.5), NUGGET)[0])
        times.append((time.perf_counter() - t0) * 1e3)
    res.update(mra_eval_ms=statistics.median(times), first_s=first_s,
               float32=ll, dropped_rows=dropped,
               eval_launches=_launches(counters),
               eval_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  cuda float32: loglik {ll!r}, rows dropped {dropped}; first "
        f"call {first_s:.2f} s; mra_eval_ms {res['mra_eval_ms']:.2f} "
        f"(median of 3); launches {res['eval_launches']}; peak "
        f"{res['eval_peak_bytes'] / 2**30:.3f} GiB")
    _require("MRA evaluation", res["eval_launches"])
    _reset(counters + bwd_counters)
    torch.cuda.reset_peak_memory_stats()
    fng = gt.loglik_fn(spec, device="cuda", dtype=dt)
    first = value_grad(fng, zt, NUGGET)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = value_grad(fng, zt, NUGGET)
        times.append((time.perf_counter() - t0) * 1e3)
    if not (np.isfinite(out[0]) and np.all(np.isfinite(out[1]))
            and np.isfinite(float(out[2]))):
        raise AssertionError("MRA: value or gradient not finite")
    res.update(value_grad_ms=statistics.median(times), grad=first,
               vg_launches=_launches(counters + bwd_counters),
               vg_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  cuda float32 value+grad: dcovparms {first[1]}, dnugget "
        f"{float(first[2])!r}; {res['value_grad_ms']:.2f} ms (median of 3); "
        f"launches {res['vg_launches']}; peak "
        f"{res['vg_peak_bytes'] / 2**30:.3f} GiB")
    _require("MRA value+grad", res["vg_launches"])
    _hold_value_grad("MRA", spec, z, big, res)
    if not big:
        fspec, fsecs = mra_spec(locs, m, "firstm")
        fmf, fplan_s, fshape = _plan_shape(fspec)
        log(f"  firstm: spec {fsecs['total']:.2f} s, plan {fplan_s:.2f} s; "
            f"levels (fronts, pivots, border): {fshape['levels']}")
        fres = dict(spec_s=fsecs["total"], plan_s=fplan_s, **fshape)
        fres["plan_kernels"] = _plan_kernel_checks("firstm", fmf, dev, seed)
        del fmf
        _reset(counters + bwd_counters)
        fres["grad"] = value_grad(gt.loglik_fn(fspec, device="cuda",
                                               dtype=dt),
                                  zt, NUGGET)
        fres["float32"] = fres["grad"][0]
        fres["launches"] = _launches(counters + bwd_counters)
        log(f"  firstm cuda float32: loglik {fres['float32']!r}, dcovparms "
            f"{fres['grad'][1]}, dnugget {float(fres['grad'][2])!r}; "
            f"launches {fres['launches']}")
        _hold_value_grad("firstm", fspec, z, big, fres)
        res["firstm"] = fres
        del fspec
    return spec, res


def _exp_np(d):
    """The Matern at smoothness 0.5 and COVPARMS as a numpy function of
    distance, for ``get_mat_cov``."""
    return COVPARMS[0] * np.exp(-d / COVPARMS[1])


def selected_phase(spec, z, packed):
    """The selected (n, m+1) layout on the MRA spec (default size only): the
    matrix from ``get_mat_cov(spec, _exp_np)`` and the packed pair slots
    ((n, P) int32, ``sel_pair_slots_packed``) timed, then the likelihood
    held against
    ``covmodel="matern"`` at COVPARMS in f64 (CROSS_REL) and f32
    (SLICE_F32_REL), its nugget gradient in f64 (GRAD_F64_REL), and the
    prediction mean alike (PRED_F64_REL, PRED_F32_REL of its max).  The
    counts of ``packed`` (H8, solve_e0_bwd) are set to 0 first and must be
    positive after."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.hv import get_mat_cov
    from gpvecchia_torch.plan import sel_pair_slots_packed
    t0 = time.perf_counter()
    sel = get_mat_cov(spec, _exp_np)
    mat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slots = sel_pair_slots_packed(spec)
    res = dict(get_mat_cov_s=mat_s, pair_slots_s=time.perf_counter() - t0,
               pair_slots_bytes=slots.nbytes)
    log(f"  get_mat_cov {mat_s:.2f} s; packed pair slots "
        f"{res['pair_slots_s']:.2f} s, {slots.nbytes / 2**20:.1f} MiB")
    del slots
    _reset(packed)
    ok = True
    for dt, tol, ptol in ((torch.float64, CROSS_REL, PRED_F64_REL),
                          (torch.float32, SLICE_F32_REL, PRED_F32_REL)):
        name = str(dt).split(".")[-1]
        zt = torch.as_tensor(z, dtype=dt, device="cuda")
        fs = gt.loglik_fn(spec, sel, device="cuda", dtype=dt)
        fm = gt.loglik_fn(spec, device="cuda", dtype=dt)
        a = float(fs(zt, (), NUGGET))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(fs(zt, (), NUGGET))
            times.append((time.perf_counter() - t0) * 1e3)
        b = float(fm(zt, COVPARMS, NUGGET))
        mu = [gt.vecchia_prediction(z, spec, cp, NUGGET, covmodel=cm,
                                    return_values="mean", device="cuda",
                                    dtype=dt)["mu_obs"]
              for cm, cp in ((sel, ()), ("matern", COVPARMS))]
        r = dict(loglik=a, matern=b, rel=abs(a - b) / abs(b),
                 eval_ms=statistics.median(times),
                 mean_rel=float(np.abs(mu[0] - mu[1]).max()
                                / np.abs(mu[1]).max()))
        line = (f"  cuda {name}: selected {a!r} vs matern {b!r}: rel "
                f"{r['rel']:.3e} (tol {tol:g}); eval {r['eval_ms']:.2f} ms "
                f"(median of 3); prediction mean {r['mean_rel']:.3e} of its "
                f"max (tol {ptol:g})")
        ok = ok and r["rel"] <= tol and r["mean_rel"] <= ptol
        if dt == torch.float64:
            dg = []
            for fn, cp in ((fs, ()), (fm, COVPARMS)):
                g = torch.tensor(NUGGET, dtype=torch.float64,
                                 requires_grad=True)
                ll = fn(zt, torch.tensor(cp, dtype=torch.float64), g)
                dg.append(float(torch.autograd.grad(ll, g)[0]))
            r.update(dnugget=dg[0], dnugget_matern=dg[1],
                     dnugget_rel=abs(dg[0] - dg[1]) / abs(dg[1]))
            line += (f"; dnugget {dg[0]!r} vs {dg[1]!r}: rel "
                     f"{r['dnugget_rel']:.3e} (tol {GRAD_F64_REL:g})")
            ok = ok and r["dnugget_rel"] <= GRAD_F64_REL
        res[name] = r
        log(line)
    res["launches"] = _launches(packed)
    log(f"  launches: {res['launches']}")
    _require("selected layout", res["launches"])
    if not ok:
        raise AssertionError("selected layout: disagrees with the built-in "
                             "Matern")
    return res


def _cfg5b_vg(spec, z):
    """(vg, calls): bench.py cfg5b's log posterior on the card in f32 -- the
    log-likelihood at covparms (exp(lg0), exp(lg1), 0.5) and nugget 0.1,
    no prior -- and its gradient, numpy float64 on the host."""
    import gpvecchia_torch as gt
    fn = gt.loglik_fn(spec, device="cuda", dtype=torch.float32)
    zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")
    nu = torch.tensor([0.5], dtype=torch.float64)
    calls = [0]

    def vg(lg):
        calls[0] += 1
        lgt = torch.tensor(lg, dtype=torch.float64, requires_grad=True)
        ll = fn(zt, torch.cat([torch.exp(lgt), nu]), NUGGET)
        (g,) = torch.autograd.grad(ll, lgt)
        return float(ll.detach()), g.numpy()

    return vg, calls


def nuts_phase(spec_m, locs, z, big, counters, gen_counters):
    """(a) bench.py cfg5b on the MRA spec: one NUTS transition (max_depth 2,
    step 0.05, unit inverse mass, theta0 = 0, smoothness 0.5 fixed, nugget
    0.1, f32), once warm and once timed (``nuts_transition_ms``), then one
    with the step NUTS_ND_STEP / |grad log p(theta0)|max, which does not
    diverge (``nuts_full_transition_ms``): each with its value+grads, how
    its trajectory ended, and the counts of ``counters`` (H1-H7) set to 0
    just before it and read just after.  (b) at the default size,
    ``sample_posterior`` on an MRA spec of the first NUTS_N points, m =
    NUTS_M (smoothness sampled: the general H1 and H5, ``gen_counters``),
    f64, on the card and on the CPU plain path from one seed: the draws
    must agree to NUTS_REL relative.  Returns (results, (spec, z, keywords,
    the card's draws) of (b), None at n > 1e5)."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.fit import mcmc as TM
    rng = TM.TorchKeys()
    vg, calls = _cfg5b_vg(spec_m, z)
    th0 = np.zeros(2)
    depth = 2

    def timed(key, eps):
        _reset(counters)
        calls[0], info = 0, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        th1, astat = TM._nuts_transition(vg, rng, rng.key(key), th0, eps,
                                         np.ones(2), depth, info=info)
        ms = (time.perf_counter() - t0) * 1e3
        if not (np.all(np.isfinite(th1)) and np.isfinite(astat)):
            raise AssertionError("cfg5b: theta or accept statistic not "
                                 "finite")
        return dict(ms=ms, value_grads=calls[0], step_size=eps,
                    theta=th1.tolist(), accept_stat=float(astat), **info,
                    launches=_launches(counters))

    timed(0, 0.05)                      # warm-up
    div = timed(1, 0.05)
    full = timed(1, NUTS_ND_STEP / np.abs(vg(th0)[1]).max())
    res = dict(nuts_transition_ms=div["ms"], value_grads=div["value_grads"],
               nuts_full_transition_ms=full["ms"], divergent=div,
               full=full)
    for name, r in (("as bench.py", div), ("at the small step", full)):
        end = ("diverged" if r["diverged"] else "turned" if r["turned"]
               else f"ran all {depth} doublings")
        log(f"  cfg5b {name}, step {r['step_size']:.6g}: {r['ms']:.2f} ms, "
            f"{r['value_grads']} value+grads ({r['ms'] / r['value_grads']:.2f}"
            f" ms each), {r['depth']} doubling(s), {end}; theta "
            f"{r['theta']}, accept stat {r['accept_stat']:.6f}; launches "
            f"{r['launches']}")
        _require(f"cfg5b {name}", r["launches"])
    if full["diverged"]:
        raise AssertionError("cfg5b: the transition at the small step "
                             "diverged")
    if big:
        return res, None
    nb = min(NUTS_N, len(z))
    spec = gt.vecchia_specify(locs[:nb], m=NUTS_M, conditioning="mra")
    kw = dict(num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES,
              num_chains=NUTS_CHAINS, seed=NUTS_SEED, max_depth=NUTS_DEPTH)
    _reset(gen_counters)
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[dev] = TM.sample_posterior(spec, z[:nb], device=dev, **kw)
        secs[dev] = time.perf_counter() - t0
        if dev == "cuda":
            launches = _launches(gen_counters)
    a, b = out["cuda"]["samples"], out["cpu"]["samples"]
    rel = np.abs(a - b) / np.abs(b)
    res["posterior"] = dict(n=nb, m=NUTS_M, **kw, cuda_s=secs["cuda"],
                            cpu_s=secs["cpu"], launches=launches,
                            rel=float(rel.max()),
                            step_size=out["cuda"]["step_size"].tolist(),
                            accept=float(out["cuda"]["accept_stats"].mean()))
    log(f"  sample_posterior n={nb}, m={NUTS_M}, f64, {kw}: cuda "
        f"{secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s; draws cuda vs cpu "
        f"{rel.max():.3e} relative (tol {NUTS_REL:g}); step sizes "
        f"{res['posterior']['step_size']}; launches {launches}")
    _require("sample_posterior", launches)
    if not rel.max() <= NUTS_REL:
        c, d = np.unravel_index(np.argmax(~(rel <= NUTS_REL)), rel.shape)
        vgs = {dev: TM.logpost_value_grad(
            spec, z[:nb], dim=a.shape[2], device=dev)
            for dev in ("cuda", "cpu")}
        start = (out["cpu"]["samples_log"][c, d - 1] if d else None)
        gap = (abs(vgs["cuda"](start)[0] - vgs["cpu"](start)[0])
               if start is not None else float("nan"))
        log(f"  the chains part at chain {c}, draw {d}: cuda "
            f"{out['cuda']['samples_log'][c, d]}, cpu "
            f"{out['cpu']['samples_log'][c, d]}, accept stats "
            f"{out['cuda']['accept_stats'][c, d]!r} / "
            f"{out['cpu']['accept_stats'][c, d]!r}; the log-likelihood's "
            f"card-vs-CPU gap at the transition's start {gap:.3e}, which "
            "bounds the margin of the decision that parted them")
        raise AssertionError("sample_posterior: the card's chains disagree "
                             "with the CPU's")
    return res, (spec, z[:nb], kw, out["cuda"])


# ---------------------------------------------------------------- V path --

V_SUB_N, V_SUB_PRED = 20_000, 2_000
V_GRAD_F32_REL = 1e-4
V_ZERO_EVERY = 100         # every 100th observation exact in the zero case


def _ms(fn, reps):
    """Median wall milliseconds of fn() over reps runs, the card synchronized
    before and after each (host and device time: the V engine's Python
    level loop is part of it)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def v_host(label, spec, selinv=True):
    """The per-entry V machinery's host side of ``spec``: ensure_v's seconds
    (V pattern, symbolic fill, factor and solve schedules), with
    ``selinv`` the selected inverse's level maps' seconds (built on the
    host, then put on the card), v_nnz and the level counts."""
    from gpvecchia_torch.inference.prediction import _selinv_levels
    from gpvecchia_torch.plan import ensure_v, get_plan
    plan = get_plan(spec)
    t0 = time.perf_counter()
    ensure_v(plan)
    ens = time.perf_counter() - t0
    sel = None
    if selinv:
        t0 = time.perf_counter()
        _selinv_levels(plan, torch.device("cuda"))
        sel = time.perf_counter() - t0
    out = dict(mode=plan.mode, ic0=plan.ic0, n_lat=plan.n_lat,
               ensure_v_s=ens, selinv_maps_s=sel, v_nnz=plan.v_nnz,
               v_phys_size=plan.v_phys_size,
               factor_levels=sum(len(b.offsets) for b in plan.factor_buckets),
               fwd_levels=sum(len(b.offsets) for b in plan.fwd_blocks),
               bwd_levels=sum(len(b.offsets) for b in plan.bwd_blocks))
    log(f"  {label}: mode {out['mode']} (ic0 {out['ic0']}), n_lat "
        f"{out['n_lat']}, ensure_v {ens:.2f} s"
        + ("" if sel is None else f", selected-inverse maps {sel:.2f} s")
        + f"; v_nnz {out['v_nnz']}, physical {out['v_phys_size']}; levels: "
        f"factor {out['factor_levels']}, forward solve {out['fwd_levels']}, "
        f"backward solve and selected inverse {out['bwd_levels']}")
    return out


def _v_counts(label, h1, h5, mf, grad):
    """The V path's launch counts: H1 (and H5 after a gradient) positive,
    the multifrontal kernels H2-H4 never."""
    launches = _launches((h1, h5) + mf)
    log(f"  {label} launches: {launches}")
    if launches[h1] <= 0 or (grad and launches[h5] <= 0) or any(
            launches[k] for k in mf):
        raise AssertionError(f"{label}: H1{' and H5' if grad else ''} must "
                             f"launch and H2-H4 must not: {launches}")
    return launches


def _grad_err(got, ref):
    """max |difference| over (dcovparms, dnuggets) over the reference's
    |g|max (joint: the zy family's likelihood does not depend on the
    covariance parameters, so their gradient alone is rounding)."""
    scale = max(np.abs(ref[1]).max(), np.abs(ref[2]).max())
    return max(np.abs(got[i] - ref[i]).max() for i in (1, 2)) / scale


def v_lik(label, spec, z, nug, grad, counters):
    """Likelihood (and value+grad) of ``spec`` on the card in f64 and f32:
    f32 timed (median of 5 evaluations, of 3 value+grads), two f32
    value+grads bit for bit, f32 against f64."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.inference.likelihood import zero_nugget_variant
    h1, h5, mf = counters
    _reset((h1, h5) + mf)
    # zero nuggets: loglik_fn takes the variant spec, as vecchia_likelihood
    spec_v = zero_nugget_variant(spec, np.broadcast_to(
        np.asarray(nug, np.float64), (spec.n_obs,)))
    res = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        t0 = time.perf_counter()
        ll = gt.vecchia_likelihood(z, spec, COVPARMS, nug, device="cuda",
                                   dtype=dt)
        r = dict(loglik=ll, first_s=time.perf_counter() - t0)
        fn = gt.loglik_fn(spec_v, device="cuda", dtype=dt)
        zt = torch.as_tensor(z, dtype=dt, device="cuda")
        r["eval_ms"] = _ms(lambda: fn(zt, COVPARMS, nug).item(), 5)
        if grad:
            first = value_grad(fn, zt, nug)
            r["value_grad_ms"] = _ms(lambda: value_grad(fn, zt, nug), 3)
            again = value_grad(fn, zt, nug)
            r["bit_equal"] = first[0] == again[0] and all(
                np.array_equal(first[i], again[i]) for i in (1, 2))
            r["grad"] = first
            if not (np.all(np.isfinite(first[1])) and np.all(
                    np.isfinite(first[2])) and r["bit_equal"]):
                raise AssertionError(f"{label} {name}: gradient not finite "
                                     "or not bit-reproducible")
        if not np.isfinite(ll):
            raise AssertionError(f"{label} {name}: loglik {ll}")
        res[name] = r
        log(f"  {label} cuda {name}: loglik {ll!r}, first call "
            f"{r['first_s']:.2f} s, eval {r['eval_ms']:.2f} ms"
            + (f", value+grad {r['value_grad_ms']:.2f} ms, dcovparms "
               f"{r['grad'][1]}, two value+grads bit-equal {r['bit_equal']}"
               if grad else ""))
    res["launches"] = _v_counts(label, h1, h5, mf, grad)
    e = abs(res["float32"]["loglik"] - res["float64"]["loglik"]) \
        / abs(res["float64"]["loglik"])
    res["f32_vs_f64"] = dict(value=e)
    msg = f"  {label} f32 vs f64: value {e:.3e} (tol {SLICE_F32_REL:g})"
    ok = e <= SLICE_F32_REL
    if grad:
        eg = _grad_err(res["float32"]["grad"], res["float64"]["grad"])
        res["f32_vs_f64"]["grad"] = eg
        msg += f", gradient {eg:.3e} of |g|max (tol {V_GRAD_F32_REL:g})"
        ok = ok and eg <= V_GRAD_F32_REL
    log(msg)
    if not ok:
        raise AssertionError(f"{label}: f32 disagrees with f64")
    for name in ("float64", "float32"):
        if grad:
            res[name]["grad"] = _jsonable(res[name]["grad"])
    return res


def v_pred(label, spec, z, counters, selinv=True):
    """vecchia_prediction of ``spec`` on the card in f64 and f32 (the exact
    prediction variances on obspred specs), f32 against f64; then the f32
    mean, selected inverse and exact variances timed apart (medians of 5,
    3 for the exact variances).  Without ``selinv`` (n > 1e5: its host
    maps take minutes there) the means and the exact prediction variances
    alone."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.inference.prediction import (_exact_pred_vars,
                                                      _pred_fns)
    h1, h5, mf = counters
    _reset((h1, h5) + mf)
    outs, res = {}, {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        t0 = time.perf_counter()
        out = gt.vecchia_prediction(z, spec, COVPARMS, NUGGET, device="cuda",
                                    dtype=dt, return_values="all" if selinv
                                    else "meanmat")
        if not selinv:
            out["var_pred"] = _exact_pred_vars(spec, out["_plan"], out["V"])
        res[name] = dict(first_s=time.perf_counter() - t0)
        del out["V"], out["_plan"]
        _check_pred(f"{label} {name}", out, spec)
        outs[name] = out
    (mean_fn, var_fn), plan = _pred_fns(spec, "matern", torch.device("cuda"),
                                        torch.float32)
    zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")
    _, v = mean_fn(zt, COVPARMS, NUGGET)
    r = res["float32"]
    r["mean_ms"] = _ms(lambda: mean_fn(zt, COVPARMS, NUGGET), 5)
    if selinv:
        r["selinv_ms"] = _ms(lambda: var_fn(v), 5)
    if spec.n_pred:
        r["var_exact_ms"] = _ms(lambda: _exact_pred_vars(spec, plan, v), 3)
    res["launches"] = _v_counts(label, h1, h5, mf, False)
    e32 = _pred_errors(outs["float32"], outs["float64"])
    res["f32_vs_f64"] = e32
    log(f"  {label} cuda float32: mean {r['mean_ms']:.2f} ms"
        + (f", selected inverse {r['selinv_ms']:.2f} ms" if selinv else "")
        + (f", exact prediction variances ({spec.n_pred}) "
           f"{r['var_exact_ms']:.2f} ms" if spec.n_pred else "")
        + "; f32 vs f64: " + ", ".join(f"{k} {v:.3e}" for k, v in e32.items())
        + f" (tol {PRED_F32_REL:g})")
    if max(e32.values()) > PRED_F32_REL:
        raise AssertionError(f"{label}: f32 prediction disagrees with f64")
    return res, outs["float64"]


def v_check(specs, locs, locs_pred, z, zb):
    """f64 on the card against the CPU plain path on sub-size specs (the
    first V_SUB_N points, V_SUB_PRED prediction points) of each V case:
    values and predictions to PRED_F64_REL of each output's max, gradients
    to GRAD_F64_REL of |g|max, the VL solve as ``vl_phase``'s check."""
    import gpvecchia_torch as gt
    n, npred = min(V_SUB_N, z.size), min(V_SUB_PRED, locs_pred.shape[0])
    zc, nug0 = z[:n], np.where(np.arange(n) % V_ZERO_EVERY == 0, 0.0, NUGGET)
    errs = {}
    t0 = time.perf_counter()
    for label, kw in specs.items():
        kw = dict(kw)
        if kw.pop("pred", False):
            kw["locs_pred"] = locs_pred[:npred]
        sub = gt.vecchia_specify(locs[:n], **kw)
        run = {}
        for dev in ("cuda", "cpu"):
            r = {}
            zt = torch.as_tensor(zc, device=dev)
            if "pred" in label:
                r["pred"] = gt.vecchia_prediction(zc, sub, COVPARMS, NUGGET,
                                                  device=dev,
                                                  return_values="meanvar")
            else:
                r["vg"] = value_grad(gt.loglik_fn(sub, device=dev), zt,
                                     NUGGET)
            if label == "ic0":
                r["pred"] = gt.vecchia_prediction(zc, sub, COVPARMS, NUGGET,
                                                  device=dev,
                                                  return_values="meanvar")
            if label == "zy":
                r["zero"] = gt.vecchia_likelihood(zc, sub, COVPARMS, nug0,
                                                  device=dev)
                r["vl"] = gt.calculate_posterior_VL(
                    zb[:n], sub, "logistic", COVPARMS, max_iter=VL_MAX_ITER,
                    device=dev)
            run[dev] = r
        g, c = run["cuda"], run["cpu"]
        e = {}
        if "vg" in c:
            e["value"] = abs(g["vg"][0] - c["vg"][0]) / abs(c["vg"][0])
            e["grad"] = _grad_err(g["vg"], c["vg"])
        if "pred" in c:
            e.update(_pred_errors(g["pred"], c["pred"]))
        if "zero" in c:
            e["zero_nugget_value"] = abs(g["zero"] - c["zero"]) / abs(
                c["zero"])
        if "vl" in c:
            if (g["vl"]["iter"], g["vl"]["cnvgd"]) != (c["vl"]["iter"],
                                                         c["vl"]["cnvgd"]):
                raise AssertionError("V check: the VL solves part")
            for k in ("mean", "D"):
                e["vl_" + k] = float(np.abs(g["vl"][k] - c["vl"][k]).max()
                                     / np.abs(c["vl"][k]).max())
        errs[label] = e
        tol = {k: GRAD_F64_REL if k == "grad" else
               VL_F64_REL if k.startswith("vl") else PRED_F64_REL for k in e}
        log(f"  n={n}: {label} cuda f64 vs cpu f64: " + ", ".join(
            f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in e.items()))
        if any(v > tol[k] for k, v in e.items()):
            raise AssertionError(f"V check {label}: the card's f64 disagrees "
                                 "with the CPU's")
    log(f"  sub-size checks: {time.perf_counter() - t0:.1f} s")
    return errs


def v_shapes(spec, seed, dev):
    """H1 and H5 against their plain versions at the zy plan's shapes: all
    its n_all rows, where each latent conditions on its own response at
    distance 0 (the rows the V path's likelihood gives H1; not the main
    path's: in no ``kernels`` row)."""
    from gpvecchia_torch.plan import get_plan
    plan = get_plan(spec)
    n = spec.n_obs
    NN, valid, cond = plan.NN, plan.valid, plan.cond
    own = np.arange(n, 2 * n)[:, None] - n
    if not np.any(valid[n:2 * n] & ~cond[n:2 * n] & (NN[n:2 * n] == own)):
        raise AssertionError("zy shapes: no latent conditions on its own "
                             "response")
    h1 = KernelCheck("matern_solve_e0")
    h5 = KernelCheck("matern_solve_e0_bwd")
    h15_run(h1, h5, plan.locs, NN, valid, valid & ~cond,
            f"zy n_all={NN.shape[0]} F={NN.shape[1]}", False, seed, dev)
    return {"matern_solve_e0": h1.rows, "matern_solve_e0_bwd": h5.rows}


def vpath_phase(locs, z, zb, locs_pred, m, big, counters, dev, seed,
                profile=False):
    """The per-entry V engine on the card through the entry points: the zy
    family's direct mode (likelihood f64/f32, value+grad, zero nuggets,
    prediction with exact variances on the default spec with prediction
    points, vecchia_pred, VL), obspred SGV (prediction, exact variances)
    and IC0 (likelihood, value+grad, prediction); at n > 1e5 the direct
    mode's likelihood and prediction only.  Every case resets the launch
    counts: H1 (and H5 with a gradient) launch, H2-H4 never.  Then the f64
    sub-size checks against the CPU (``v_check``) and H1/H5 at the zy
    shapes (``v_shapes``); with ``profile`` ``profile_vpath``."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.fit.mle import vecchia_pred
    specs = {"zy": dict(m=m, cond_yz="zy"), "zy_pred": dict(m=m, pred=True)}
    if not big:
        specs["obspred_pred"] = dict(m=m, pred=True, cond_yz="SGV",
                                     ordering_pred="obspred")
        specs["ic0"] = dict(m=m, cond_yz="SGV", ic0=True)
    res, built = {"host": {}}, {}
    for label, kw in specs.items():
        kw = dict(kw)
        if kw.pop("pred", False):
            kw["locs_pred"] = locs_pred
        t0 = time.perf_counter()
        built[label] = gt.vecchia_specify(locs, **kw)
        spec_s = time.perf_counter() - t0
        res["host"][label] = dict(v_host(label, built[label], not big),
                                  spec_s=spec_s)
    torch.cuda.reset_peak_memory_stats()
    res["zy"] = v_lik("zy", built["zy"], z, NUGGET, True, counters)
    res["zy_pred"], _ = v_pred("zy_pred", built["zy_pred"], z, counters,
                               not big)
    if not big:
        nug0 = np.where(np.arange(z.size) % V_ZERO_EVERY == 0, 0.0, NUGGET)
        res["zy_zero_nugget"] = v_lik("zy zero nuggets", built["zy"], z,
                                      nug0, False, counters)
        res["obspred"], _ = v_pred("obspred_pred", built["obspred_pred"], z,
                                   counters)
        res["ic0"] = v_lik("ic0", built["ic0"], z, NUGGET, True, counters)
        res["ic0_pred"], _ = v_pred("ic0", built["ic0"], z, counters)
        h1, h5, mf = counters
        _reset((h1, h5) + mf)
        est = dict(z=z, locs=locs, theta_hat=np.array([*COVPARMS, NUGGET]),
                   covmodel="matern", trend="none", beta_hat=np.zeros(0))
        t0 = time.perf_counter()
        vp = vecchia_pred(est, locs_pred, m=m, device="cuda",
                          dtype=torch.float32)
        vp_s = time.perf_counter() - t0
        if vp["mean_pred"].shape != (locs_pred.shape[0],) or not (
                np.all(np.isfinite(vp["mean_pred"]))
                and np.all(vp["var_pred"] > 0)):
            raise AssertionError("vecchia_pred: not finite or not positive")
        res["vecchia_pred"] = dict(seconds=vp_s, launches=_v_counts(
            "vecchia_pred", h1, h5, mf, False))
        log(f"  vecchia_pred (default spec, f32, spec included): "
            f"{vp_s:.2f} s")
        _reset((h1, h5) + mf)
        kw = dict(max_iter=VL_MAX_ITER, device="cuda", dtype=torch.float32)
        gt.calculate_posterior_VL(zb, built["zy"], "logistic", COVPARMS, **kw)
        post = gt.calculate_posterior_VL(zb, built["zy"], "logistic",
                                         COVPARMS, **kw)
        if not np.all(np.isfinite(post["mean"])):
            raise AssertionError("VL on the zy spec: mean not finite")
        res["vl_zy"] = dict(nr_ms=post["runtime"] * 1e3, iters=post["iter"],
                            cnvgd=post["cnvgd"], launches=_v_counts(
                                "VL zy", h1, h5, mf, False))
        log(f"  VL zy (logistic, f32): NR solve {post['runtime'] * 1e3:.2f} "
            f"ms, {post['iter']} iterations, converged {post['cnvgd']}")
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {res['peak_bytes'] / 2**30:.3f} GiB")
    if not big:
        res["check"] = v_check(specs, locs, locs_pred, z, zb)
    res["shapes"] = v_shapes(built["zy"], seed, dev)
    if profile:
        profile_vpath(built, z, big)
    return res


def profile_vpath(built, z, big):
    """One warm f32 value+grad of the zy spec and of the IC0 spec, one
    prediction mean of the obspred spec and its exact prediction variances
    (the default prediction spec's at n > 1e5) under torch.profiler;
    ``built`` holds ``vpath_phase``'s specs."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.inference.prediction import (_exact_pred_vars,
                                                      _pred_fns)
    zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")
    for label in ("zy",) + (() if big else ("ic0",)):
        fn = gt.loglik_fn(built[label], device="cuda", dtype=torch.float32)
        profile_call(f"{label} value+grad at {COVPARMS}", lambda: (
            value_grad(fn, zt, NUGGET), torch.cuda.synchronize()))
        del fn
    label = "zy_pred" if big else "obspred_pred"
    spec = built[label]
    (mean_fn, _), plan = _pred_fns(spec, "matern", torch.device("cuda"),
                                   torch.float32)
    held = {}

    def mean():
        held["v"] = mean_fn(zt, COVPARMS, NUGGET)[1]
        torch.cuda.synchronize()

    def exact():
        _exact_pred_vars(spec, plan, held["v"])
        torch.cuda.synchronize()

    profile_call(f"{label} prediction mean at {COVPARMS}", mean)
    profile_call(f"{label} exact prediction variances", exact)
    held.clear()


def v_names(vp):
    """The V path's f32 timings under their names in the summary."""
    out = dict(zy_eval_ms=vp["zy"]["float32"]["eval_ms"],
               zy_vg_ms=vp["zy"]["float32"]["value_grad_ms"],
               zy_pred_mean_ms=vp["zy_pred"]["float32"]["mean_ms"],
               zy_pred_selinv_ms=vp["zy_pred"]["float32"].get("selinv_ms"),
               zy_pred_var_exact_ms=vp["zy_pred"]["float32"]["var_exact_ms"])
    if "ic0" in vp:
        out.update(
            obspred_pred_mean_ms=vp["obspred"]["float32"]["mean_ms"],
            obspred_selinv_ms=vp["obspred"]["float32"]["selinv_ms"],
            obspred_var_exact_ms=vp["obspred"]["float32"]["var_exact_ms"],
            ic0_eval_ms=vp["ic0"]["float32"]["eval_ms"],
            ic0_vg_ms=vp["ic0"]["float32"]["value_grad_ms"],
            ic0_pred_mean_ms=vp["ic0_pred"]["float32"]["mean_ms"],
            ic0_selinv_ms=vp["ic0_pred"]["float32"]["selinv_ms"],
            vl_zy_nr_ms=vp["vl_zy"]["nr_ms"])
    return out


# ------------------------------------------------------------------ mesh --

# a rank run's time limit (spawn, set-up and every computation of a rank)
MESH_TIMEOUT = 900.0
# sharded vs single-process on the card, f64 at the default size: value
# relative, gradient as max |difference| over the reference's |g|max in
# (covparms, nugget), posterior mean and variances over each one's max;
# f32 sharded vs single-process f64: SLICE_F32_REL (value), PRED_F32_REL
# (posterior)
MESH_F64_REL, MESH_GRAD_F64_REL, MESH_POST_F64_REL = 1e-10, 1e-8, 1e-10


# the kernels whose launches the mesh phase counts
_MESH_KERNELS = ("matern_solve_e0", "leaf_assemble", "extend_add",
                 "front_factor", "matern_solve_e0_bwd", "extend_add_bwd",
                 "leaf_assemble_bwd", "front_factor_bwd")


def _grad_rel(got, ref):
    """max |got - ref| over (covparms, nugget) jointly, over |ref|max."""
    g = np.concatenate([np.ravel(got[1]), np.ravel(got[2])])
    r = np.concatenate([np.ravel(ref[1]), np.ravel(ref[2])])
    return float(np.abs(g - r).max() / np.abs(r).max())


def mesh_rank(rank, world, spec_path, z, nuts_path, nuts_z, nuts_kw, big):
    """One rank of the mesh phase, run by ``parallel.mesh.run_local``: the
    spec from ``spec_path`` (``load_spec``), the sharded f32 evaluation and
    value+grad (timed, medians of 5; the kernels' launch counts and the
    bytes exchanged over one evaluation and one value+grad; two value+grads
    compared bit for bit), at the default size also f64, the sharded
    posterior, and with two ranks ``sample_posterior`` over a (chains=2,
    rows=1) mesh on the NUTS spec.  Returns numpy data."""
    import torch.distributed as dist
    from gpvecchia_torch.csrc import cuda, host
    from gpvecchia_torch.parallel import mesh as PM
    from gpvecchia_torch.plan import get_plan
    from gpvecchia_torch.utils.serialize import load_spec
    dev = torch.device("cuda", torch.cuda.current_device())
    out = dict(rank=rank, world=world, backend=dist.get_backend(),
               device=str(dev))
    t0 = time.perf_counter()
    if not host.native_loaded():
        raise RuntimeError("native host library failed to load")
    cuda.get_lib()
    out["lib_s"] = time.perf_counter() - t0
    # the backend's all_reduce on a CUDA tensor, as every exchange runs it
    # (NCCL's collectives on the card; gloo takes CUDA tensors too)
    t = torch.full((4,), rank + 1.0, device=dev)
    dist.all_reduce(t)
    out["direct_all_reduce"] = f"ok, sum {t[0].item()!r}"
    t0 = time.perf_counter()
    spec = load_spec(spec_path)
    out["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = get_plan(spec)
    mesh = PM.make_mesh()
    sdev = PM.shard_rows(mesh, plan, device=dev, dtype=torch.float32)
    out["share_s"] = time.perf_counter() - t0
    mf = sdev["mf"]
    s = len(mf.top or [])
    out["share"] = dict(
        leaves=int(mf[-1]["piv_ids"].shape[0]),
        elements=int(sdev["NN"].shape[0]),
        sharded_depths=[s, s + len(mf) - 1], replicated_depths=s)
    counters = _MESH_KERNELS
    res = {}
    for dt in ((torch.float32,) if big else (torch.float32, torch.float64)):
        name = str(dt).split(".")[-1]
        fn = PM.sharded_loglik_fn(spec, mesh=mesh, dtype=dt)
        zt = torch.as_tensor(z, dtype=dt, device=dev)
        _reset(counters)
        exchanged = [_count(f"mesh.exchange.{k}") for k in ("calls", "bytes")]
        torch.cuda.reset_peak_memory_stats(dev)
        value = float(fn(zt, COVPARMS, NUGGET))
        vg = value_grad(fn, zt, NUGGET)
        r = dict(value=value, vg=vg, launches=_launches(counters),
                 exchanges={k: _count(f"mesh.exchange.{k}") - c0 for k, c0
                            in zip(("calls", "bytes"), exchanged)},
                 peak_bytes=torch.cuda.max_memory_allocated(dev))
        again = value_grad(fn, zt, NUGGET)
        r["bit_equal"] = (vg[0] == again[0] and all(
            np.array_equal(a, b) for a, b in zip(vg[1:], again[1:])))
        r["eval_ms"] = cuda_time(lambda: fn(zt, COVPARMS, NUGGET), 5)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value_grad(fn, zt, NUGGET)
            times.append((time.perf_counter() - t0) * 1e3)
        r["vg_ms"] = statistics.median(times)
        core, pdev = PM.sharded_posterior_core(spec, mesh=mesh, dtype=dt)
        mu, var = core(pdev, z, COVPARMS, NUGGET)
        r["post"] = (mu.double().cpu().numpy(), var.double().cpu().numpy())
        r["post_ms"] = cuda_time(lambda: core(pdev, z, COVPARMS, NUGGET), 3)
        res[name] = r
        del fn, core, zt
        plan.cache.clear()
    out["res"] = res
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if world == 2:
        from gpvecchia_torch.fit import mcmc as TM
        nspec = load_spec(nuts_path)
        cmesh = PM.make_mesh(rows=1, chains=2)
        t0 = time.perf_counter()
        out["nuts"] = TM.sample_posterior(nspec, nuts_z, mesh=cmesh,
                                          device="cuda", **nuts_kw)
        out["nuts_s"] = time.perf_counter() - t0
    return out


def _mesh_refs(spec, z, big):
    """The single-process f64 references on the card: the value, at the
    default size its gradient, and the posterior mean and variances."""
    import gpvecchia_torch as gt
    from gpvecchia_torch.inference.prediction import _pred_fns
    fn = gt.loglik_fn(spec, device="cuda", dtype=torch.float64)
    zt = torch.as_tensor(z, dtype=torch.float64, device="cuda")
    ref = dict(value=float(fn(zt, COVPARMS, NUGGET)))
    if not big:
        ref["vg"] = value_grad(fn, zt, NUGGET)
    (mean_fn, var_fn), _ = _pred_fns(spec, "matern", torch.device("cuda"),
                                     torch.float64)
    mu, fac = mean_fn(z, np.asarray(COVPARMS), np.full(spec.n_obs, NUGGET))
    ref["post"] = (mu.cpu().numpy(), var_fn(fac).cpu().numpy())
    del fn, zt, mu, fac
    _drop_f64_caches(spec)
    return ref


def _mesh_check(label, o, ref, big):
    """Every check of one rank's results against the references; returns
    the rank's line."""
    for name, r in o["res"].items():
        f64 = name == "float64"
        tol = MESH_F64_REL if f64 else SLICE_F32_REL
        for what, v in (("evaluation", r["value"]), ("value+grad",
                                                     r["vg"][0])):
            rel = abs(v - ref["value"]) / abs(ref["value"])
            if not rel <= tol:
                raise AssertionError(f"{label} {name} {what}: {v!r} vs the "
                                     f"single-process f64 {ref['value']!r}, "
                                     f"{rel:.3e} > {tol:g}")
        r["rel"] = abs(r["value"] - ref["value"]) / abs(ref["value"])
        if f64:
            r["grad_rel"] = _grad_rel(r["vg"], ref["vg"])
            if not r["grad_rel"] <= MESH_GRAD_F64_REL:
                raise AssertionError(f"{label} f64 gradient {r['vg'][1:]} "
                                     f"vs {ref['vg'][1:]}: {r['grad_rel']:.3e}")
        ptol = MESH_POST_F64_REL if f64 else PRED_F32_REL
        r["post_rel"] = [float(np.abs(g - w).max() / np.abs(w).max())
                         for g, w in zip(r.pop("post"), ref["post"])]
        if not max(r["post_rel"]) <= ptol:
            raise AssertionError(f"{label} {name} posterior (mean, var) "
                                 f"{r['post_rel']} > {ptol:g}")
        if not r["bit_equal"]:
            raise AssertionError(f"{label} {name}: two sharded value+grads "
                                 "differ")
        _require(f"{label} {name}", r["launches"])
        if not all(np.isfinite(r["vg"][1])) or not np.isfinite(r["vg"][2]):
            raise AssertionError(f"{label} {name}: gradient not finite")
        r["vg"] = [r["vg"][0], np.asarray(r["vg"][1]).tolist(),
                   float(r["vg"][2])]


def mesh_phase(spec, z, big, spec_s, nuts_ref, locs, smi):
    """The sharded path (``parallel/mesh.py``) on the card: the spec
    written once with ``save_spec`` and read by every rank with
    ``load_spec`` (seconds beside the spec's build time), then (a) one
    rank on NCCL and (b) two ranks on gloo, both on cuda:0 (NCCL refuses
    two ranks on one card), each rank's results held against the
    single-process f64 references on the card (``_mesh_check``), and in
    (b) ``sample_posterior`` over a (chains=2, rows=1) mesh against
    mesh=None on the NUTS spec, draw for draw.  With four cards or more,
    (b)'s ranks sit on cuda:0 and cuda:1 and (c) runs four NCCL ranks, one
    a card."""
    import tempfile
    import gpvecchia_torch as gt
    from gpvecchia_torch.fit import mcmc as TM
    from gpvecchia_torch.parallel import mesh as PM
    from gpvecchia_torch.utils.serialize import load_spec, save_spec
    t0 = time.perf_counter()
    ref = _mesh_refs(spec, z, big)
    ref_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    path = f"{tmp}/spec.npz"
    t0 = time.perf_counter()
    save_spec(spec, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_spec(path)
    load_s = time.perf_counter() - t0
    if not np.array_equal(back.NNarray, spec.NNarray):
        raise AssertionError("load_spec gave another spec")
    del back
    log(f"  spec {spec_s:.2f} s to build, save_spec {save_s:.2f} s, "
        f"load_spec {load_s:.2f} s ({os.path.getsize(path) / 2**20:.1f} "
        f"MiB); single-process f64 references {ref_s:.1f} s")
    if nuts_ref is None:
        nb = min(NUTS_N, len(z))
        nspec = gt.vecchia_specify(locs[:nb], m=NUTS_M, conditioning="mra")
        kw = dict(num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES,
                  num_chains=NUTS_CHAINS, seed=NUTS_SEED, max_depth=NUTS_DEPTH)
        t0 = time.perf_counter()
        want = TM.sample_posterior(nspec, z[:nb], device="cuda", **kw)
        log(f"  sample_posterior mesh=None on the card: "
            f"{time.perf_counter() - t0:.1f} s")
        nuts_ref = (nspec, z[:nb], kw, want)
    nspec, nz, nkw, want = nuts_ref
    npath = f"{tmp}/nuts.npz"
    save_spec(nspec, npath)
    torch.cuda.empty_cache()
    out = {"save_s": save_s, "load_s": load_s, "spec_s": spec_s}
    try:
        runs = [("(a) nccl", 1, "nccl"), ("(b) gloo", 2, "gloo")]
        if torch.cuda.device_count() >= 4:
            # a rank on each of four cards: the exchanges cross NVLink
            runs.append(("(c) nccl", 4, "nccl"))
        for label, world, backend in runs:
            t0 = time.perf_counter()
            ranks = PM.run_local(mesh_rank, world, path, z, npath, nz, nkw,
                                 big, backend=backend, device="cuda",
                                 timeout=MESH_TIMEOUT)
            secs = time.perf_counter() - t0
            log(f"  {label}: {world} rank(s), backend {backend}, devices "
                f"{[o['device'] for o in ranks]}, {secs:.1f} s; the "
                f"backend's own CUDA all_reduce: "
                f"{[o['direct_all_reduce'] for o in ranks]}")
            vals = {o["res"]["float32"]["value"] for o in ranks}
            if len(vals) != 1:
                raise AssertionError(f"{label}: the ranks' values differ: "
                                     f"{vals}")
            for o in ranks:
                _mesh_check(f"{label} rank {o['rank']}", o, ref, big)
                for name, r in o["res"].items():
                    log(f"    rank {o['rank']} {name}: leaves "
                        f"{o['share']['leaves']}, elements "
                        f"{o['share']['elements']}, sharded depths "
                        f"{o['share']['sharded_depths']}, replicated "
                        f"{o['share']['replicated_depths']}; value "
                        f"{r['value']!r} (rel {r['rel']:.3e}"
                        + (f", grad {r['grad_rel']:.3e}" if "grad_rel" in r
                           else "")
                        + f"), posterior {[f'{x:.2e}' for x in r['post_rel']]}"
                        f"; exchanged {r['exchanges']['bytes']} B in "
                        f"{r['exchanges']['calls']} calls (eval + "
                        f"value+grad); launches {r['launches']}; peak "
                        f"{r['peak_bytes'] / 2**30:.3f} GiB; eval "
                        f"{r['eval_ms']:.2f} ms, value+grad {r['vg_ms']:.2f}"
                        f" ms, posterior {r['post_ms']:.2f} ms; spec load "
                        f"{o['load_s']:.2f} s, share {o['share_s']:.2f} s")
                if world == 2:
                    got = o.pop("nuts")
                    same = all(np.array_equal(got[k], want[k]) for k in (
                        "samples_log", "accept_stats", "step_size"))
                    rel = float(np.max(np.abs(got["samples"] - want["samples"])
                                       / np.abs(want["samples"])))
                    o["nuts"] = dict(bit_equal=same, rel=rel, s=o["nuts_s"])
                    log(f"    rank {o['rank']} sample_posterior (chains=2, "
                        f"rows=1) {o['nuts_s']:.1f} s: draws bit-equal to "
                        f"mesh=None {same}, rel {rel:.3e} (tol {NUTS_REL:g})")
                    if not rel <= NUTS_REL:
                        raise AssertionError("mesh: sample_posterior over the "
                                             "chains axis disagrees")
            out[label] = dict(seconds=secs, ranks=ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  the medians above: {smi}; not compared with anything")
    return out


def _jsonable(r, summary=False):
    """(loglik, dcovparms, dnuggets) as JSON values; ``summary`` keeps only
    the largest |dnuggets| of a vector."""
    ll, dc, dg = r
    dg = float(np.abs(dg).max()) if summary else float(dg)
    return dict(loglik=ll, dcovparms=[float(v) for v in dc], dnuggets=dg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1988)
    ap.add_argument("--profile", action="store_true",
                    help="profile one f32 evaluation, f32 value+grads "
                         "and one f32 prediction mean and selected inverse "
                         "(kernel time by name, device busy share)")
    ap.add_argument("--only-h4", action="store_true",
                    help="a tool for work on H4: build, H4's edge shapes and "
                         "H4 at the 14 level shapes of n=1e6, m=40, and "
                         "nothing else; prints no final device line")
    ap.add_argument("--only-h9", action="store_true",
                    help="a tool for work on H9: build, H9's edge shapes "
                         "and H9 at the 14 level shapes of n=1e6, m=40, and "
                         "nothing else; prints no final device line")
    ap.add_argument("--only-assembly", action="store_true",
                    help="a tool for work on H2 and H3: build, their edge "
                         "shapes, the spec and plan of --n and --m, H2 and "
                         "H7 at its leaf and H3 at each of its internal "
                         "levels, and nothing else; prints no final device "
                         "line")
    ap.add_argument("--only-vpath", action="store_true",
                    help="a tool for work on the per-entry V engine: build, "
                         "two f32 value+grads on the run's SGV spec held "
                         "bit for bit, the V-path phase at --n and --m "
                         "(with --profile its profiles), and nothing else; "
                         "prints no final device line")
    ap.add_argument("--only-mesh", action="store_true",
                    help="a tool for work on the sharded path: build, the "
                         "spec of --n and --m, the mesh phase, and nothing "
                         "else; prints no final device line")
    ap.add_argument("--only-h15", action="store_true",
                    help="a tool for work on H1 and H5: build, their edge "
                         "shapes and both kernels at F = 11, 21, 41 and 72 "
                         "on 1e6 Z-ordered points, and nothing else; prints "
                         "no final device line")
    ap.add_argument("--only-general", action="store_true",
                    help="a tool for work on the general H1 and H5: build, "
                         "their edge shapes and pair-list checks, then the "
                         "SGV and MRA specs of --n and --m and the pair "
                         "pass's counts and ms on their rows, and nothing "
                         "else; prints no final device line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible")
    import gpvecchia_torch as gt
    from gpvecchia_torch.csrc import cuda, host
    from gpvecchia_torch.inference.likelihood import zkey
    from gpvecchia_torch.kernels import matern_solve as MS
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
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda:0")
    if args.only_h4:
        log("H4 alone (no spec, no plan; not a pass of this script):")
        h4_edge_phase(dev, args.seed)
        rows, _ = h4_level_phase(H4_LEVELS_1E6, dev, args.seed)
        print(json.dumps({"h4_levels": rows, "smi": smi}))
        return
    if args.only_h9:
        log("H9 alone (no spec, no plan; not a pass of this script):")
        h9_edge_phase(dev, args.seed)
        rows, _ = h9_level_phase(H4_LEVELS_1E6, dev, args.seed)
        print(json.dumps({"h9_levels": rows, "smi": smi}))
        return
    if args.only_h15:
        log("H1 and H5 alone (no spec, no plan; not a pass of this script):")
        h15_edge_phase(dev, args.seed)
        h1 = KernelCheck("matern_solve_e0")
        h5 = KernelCheck("matern_solve_e0_bwd")
        for F in H15_FS:
            locs, NN, valid, resp = morton_points(H15_N, F, args.seed)
            h15_run(h1, h5, locs, NN, valid, resp,
                    f"Z-order n={H15_N} F={F} ({MS.route(F, torch.float32)})",
                    F == 41, args.seed + F, dev, against_shared=True)
            del locs, NN, valid, resp
        print(json.dumps({"h15": {"matern_solve_e0": h1.rows,
                                  "matern_solve_e0_bwd": h5.rows},
                          "smi": smi}))
        return

    if args.only_general:
        log("the general H1 and H5 alone (not a pass of this script):")
        gen_edge_phase(dev, args.seed)
        gen_list_edge_phase(dev, args.seed)
        locs = np.random.default_rng(args.seed).uniform(size=(args.n, 2))
        specs = (("SGV", gt.vecchia_specify(locs, m=args.m, cond_yz="SGV")),
                 ("MRA", mra_spec(locs, args.m)[0]))
        rows = gen_engagement(specs, dev, args.seed)
        print(json.dumps({"pair_pass": rows, "smi": smi}))
        return

    # ---- host: spec + plan ----
    rng = np.random.default_rng(args.seed)
    locs = rng.uniform(size=(args.n, 2))
    z = rng.normal(size=args.n)
    locs_pred = rng.uniform(size=(PRED_N_PRED, 2))
    zb = (rng.uniform(size=args.n) < 0.5).astype(np.float64)
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
    if args.only_vpath:
        log("the V path alone (not a pass of this script):")
        fn = gt.loglik_fn(spec, device="cuda", dtype=torch.float32)
        zt = torch.as_tensor(z, dtype=torch.float32, device="cuda")
        a, b = (value_grad(fn, zt, NUGGET) for _ in range(2))
        same = a[0] == b[0] and all(np.array_equal(a[i], b[i])
                                    for i in (1, 2))
        log(f"  SGV (multifrontal) f32 value+grad twice: {a[0]!r}, "
            f"{a[1]}, {float(a[2])!r}; bit-equal {same}")
        if not same:
            raise AssertionError("SGV value+grad not bit-reproducible")
        del fn, zt
        vpath = vpath_phase(locs, z, zb, locs_pred, args.m, args.n > 100_000,
                            ("matern_solve_e0", "matern_solve_e0_bwd",
                             ("leaf_assemble", "extend_add",
                              "front_factor")), dev, args.seed, args.profile)
        print(json.dumps({"vpath": vpath, **v_names(vpath), "smi": smi},
                         default=float))
        return
    if args.only_mesh:
        log("the mesh phase alone (not a pass of this script):")
        mesh = mesh_phase(spec, z, args.n > 100_000, spec_s, None, locs, smi)
        print(json.dumps({"mesh": mesh, "smi": smi}, default=float))
        return
    if args.only_assembly:
        log("H2 and H3 alone (not a pass of this script):")
        assembly_edge_phase(dev, args.seed)
        leaf = leaf_phase(mf, args.seed, dev)["leaf_assemble"]
        rows, sums, _, _ = eadd_level_phase(mf, dev, args.seed)
        print(json.dumps({"leaf_assemble": leaf.rows, "eadd_levels": {
            "sums": sums, "rows": rows}, "smi": smi}))
        return

    log("kernel phase (kernel vs plain version on the card):")
    checks = kernel_phase(spec, mf, args.seed, dev)
    assembly_edge_phase(dev, args.seed)
    eadd_rows, eadd_sums, h3, h6 = eadd_level_phase(mf, dev, args.seed)
    if h3.rows:
        checks["extend_add"] = h3
        checks["extend_add_bwd"] = h6
    h4_edge_phase(dev, args.seed)
    h4_levels, checks["front_factor"] = h4_level_phase(
        _level_shapes(mf), dev, args.seed)
    h9_edge_phase(dev, args.seed)
    h9_levels, checks["front_factor_bwd"] = h9_level_phase(
        _level_shapes(mf), dev, args.seed)

    log("slice phase:")
    big = args.n > 100_000
    counters = ("matern_solve_e0", "leaf_assemble", "extend_add",
                "front_factor")
    bwd_counters = ("matern_solve_e0_bwd", "extend_add_bwd",
                    "leaf_assemble_bwd", "front_factor_bwd")
    _reset(counters)
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
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches during the slice phase: {launches}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if big:
        # f32 against f64 end to end: one f64 evaluation at this size
        ll64 = gt.vecchia_likelihood(z, spec, COVPARMS, NUGGET, device="cuda",
                                     dtype=torch.float64)
        ll32 = res["float32"]["loglik"]
        r32 = abs(ll32 - ll64) / abs(ll64)
        res["float64_once"] = dict(loglik=ll64, rel_f32_f64=r32)
        log(f"  cuda float64 once: loglik {ll64!r}; f32 {ll32!r}; rel diff "
            f"f32 vs f64 {r32:.3e} (tol {SLICE_F32_REL:g})")
        if not r32 <= SLICE_F32_REL:
            raise AssertionError("slice: f32 disagrees with f64")
        # the f64 run's device arrays stay cached in the plan (1.13 GiB at
        # n=1e6): drop them, so that the later phases' peaks are f32's
        _drop_f64_caches(spec)
    key_ms = statistics.median(_host_ms(lambda: zkey(z)) for _ in range(5))
    res["zkey_ms"] = key_ms
    log(f"  z-cache key of the numpy z ({z.size} values, full digest): "
        f"{key_ms:.3f} ms on the host")

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

    log("gradient phase:")
    grad, grad_launches, grad_peak = grad_phase(spec, z, big,
                                                counters + bwd_counters)

    log("general-covariance phase (smoothness 0.8):")
    gen_counters = ("matern_solve_e0[general]",
                    "matern_solve_e0_bwd[general]") + counters[1:] \
        + bwd_counters[1:]
    gen, gen_launches, gen_peak, esqe_launches = general_phase(
        spec, z, big, gen_counters, ("solve_e0", "solve_e0_bwd"))

    log("estimation phase:")
    est = estimate_phase(locs, z, args.m, big, args.seed)

    log("prediction phase:")
    pred = pred_phase(spec, locs, z, big, counters, locs_pred)

    log("Vecchia-Laplace phase (logistic):")
    vl = vl_phase(spec, locs, zb, big, counters)

    log("MRA phase (bench.py cfg5):")
    spec_m, mra = mra_phase(locs, z, args.m, big, counters, bwd_counters,
                            dev, args.seed)
    log("general pair pass on the shared-memory route (SGV and MRA rows):")
    pair_pass = gen_engagement((("SGV", spec), ("MRA", spec_m)), dev,
                               args.seed)
    sel = None
    if not big:
        log("selected-layout phase (MRA spec):")
        sel = selected_phase(spec_m, z, ("solve_e0", "solve_e0_bwd"))
    log("NUTS phase (bench.py cfg5b, sample_posterior):")
    nuts, nuts_ref = nuts_phase(spec_m, locs, z, big,
                                counters + bwd_counters, gen_counters)
    del spec_m

    log("V-path phase (zy direct mode, obspred, IC0):")
    vpath = vpath_phase(locs, z, zb, locs_pred, args.m, big,
                        ("matern_solve_e0", "matern_solve_e0_bwd",
                         counters[1:]), dev, args.seed, args.profile)
    vnames = v_names(vpath)
    log(f"V path (f32): {vnames}")

    log("mesh phase (parallel/mesh.py: NCCL with one rank, gloo with two "
        "ranks on cuda:0):")
    mesh = mesh_phase(spec, z, big, spec_s, nuts_ref, locs, smi)
    del nuts_ref

    if args.profile:
        profile_eval(spec, z, grad=False)
        profile_eval(spec, z, grad=True)
        profile_eval(spec, z, grad=True, covparms=GEN_COVPARMS)
        profile_pred(spec, z)

    ms_cu = "gpvecchia_torch/csrc/matern_solve.cu"
    regs_cu = "gpvecchia_torch/csrc/matern_regs.cuh"  # H1, H5 at small F
    fr_cu = "gpvecchia_torch/csrc/frontal.cu"
    crout = "gpvecchia_tpu/kernels/pallas_crout.py"
    src = {"matern_solve_e0": regs_cu, "matern_solve_e0_bwd": regs_cu,
           "matern_solve_e0[general]": regs_cu,
           "matern_solve_e0_bwd[general]": regs_cu,
           "solve_e0": ms_cu, "solve_e0_bwd": ms_cu}
    replaces = {
        "matern_solve_e0": f"{crout}:268",
        "matern_solve_e0_bwd": f"{crout}:155",
        "matern_solve_e0[general]": f"{crout}:135",
        "matern_solve_e0_bwd[general]": f"{crout}:155",
        "solve_e0": f"{crout}:135",
        "solve_e0_bwd": f"{crout}:155",
        "leaf_assemble": "gpvecchia_tpu/linalg/pallas_level.py:594",
        "extend_add": "gpvecchia_tpu/linalg/pallas_level.py:344",
        "front_factor": "gpvecchia_tpu/linalg/pallas_frontal.py:180",
        "front_factor_bwd": "gpvecchia_tpu/linalg/pallas_frontal.py:249",
        "extend_add_bwd": "gpvecchia_tpu/linalg/pallas_eadd.py:117",
        "leaf_assemble_bwd": "gpvecchia_tpu/linalg/pallas_level.py:594"}
    # launches: each kernel's count on the path it serves, with the counts
    # set to 0 just before that path ran: H1-H4 from the slice phase,
    # H5-H7 from the gradient phase, the general H1 and H5 from the
    # general-covariance phase's smoothness-0.8 runs, H8 and solve_e0_bwd
    # from its esqe run
    path_launches = dict(launches,
                         **{k: grad_launches[k] for k in bwd_counters},
                         **{k: gen_launches[k] for k in gen_counters[:2]},
                         **esqe_launches)
    kernels = []
    for name, chk in checks.items():
        # f32 (the production precision) at the main path's shape
        f32 = [r for r in chk.rows if r["dtype"] == "float32"]
        row = next((r for r in f32 if r["main"]), f32[0])
        kernels.append(dict(name=name, route="cuda",
                            source=src.get(name, fr_cu),
                            replaces=replaces[name],
                            launches=path_launches[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"],
                            bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"]))
    grad_json = {k: dict(v, scalar=_jsonable(v["scalar"]),
                         vector=_jsonable(v["vector"], summary=True))
                 for k, v in grad.items()}
    gen_json = {k: (dict(v, grad=_jsonable(v["grad"]))
                    if isinstance(v, dict) and "grad" in v else v)
                for k, v in gen.items()}
    gen_json["pair_pass"] = pair_pass
    bench_names = dict(
        pred_mean_ms=pred["spec"]["float32"]["pred_mean_ms"],
        pred_selinv_ms=pred["spec"]["float32"]["pred_selinv_ms"],
        **{k: vl[k] for k in ("vl_nr_ms", "vl_iters", "vl_iter_ms",
                              "vl_cnvgd")},
        mra_spec_s=mra["mra_spec_s"], mra_eval_ms=mra["mra_eval_ms"],
        nuts_transition_ms=nuts["nuts_transition_ms"],
        nuts_full_transition_ms=nuts["nuts_full_transition_ms"])
    log(f"posterior, MRA and NUTS (f32, bench.py's names): {bench_names}")
    print(json.dumps({"slice": res, "grad": grad_json, "general": gen_json,
                      "estimate": est, "prediction": pred, "vl": vl,
                      "mra": mra, "selected": sel, "nuts": nuts,
                      "vpath": vpath, "mesh": mesh, **bench_names,
                      **vnames, "n": args.n, "m": args.m,
                      "spec_s": spec_s, "plan_s": plan_s,
                      "peak_bytes": peak, "grad_peak_bytes": grad_peak,
                      "general_peak_bytes": gen_peak,
                      "grad_launches": grad_launches,
                      "general_launches": gen_launches,
                      "esqe_launches": esqe_launches,
                      "eadd_levels": {"sums": eadd_sums, "rows": eadd_rows},
                      "h4_levels": h4_levels, "h9_levels": h9_levels,
                      "smi": smi},
                     default=float))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
