// H1 matern_solve_e0: per point, the closed-form Matern covariance of its
// conditioning set, its Cholesky factor, and x = C^{-1} e0.
// H5 matern_solve_e0_bwd: its backward, fused with the covariance rebuild
// and the contraction onto (sig2, rho) and the per-slot nuggets.
// H8 solve_e0 and solve_e0_bwd: the same solve and backward on a given
// packed covariance.
//
// H1 replaces the TPU kernel gpvecchia_tpu/kernels/pallas_crout.py
// `_fused_kernel` (pallas_call at :268, entry `fused_matern_solve`), whose
// body builds the packed covariance from transposed caches, factors it and
// solves against e0 with the point batch on the 128-wide lane axis.  H5
// replaces K2, `_solve_e0_bwd_kernel` (pallas_call at :155,
// `_solve_e0_bwd_impl`), together with the XLA covariance rebuild
// `_rebuild_cp` (:359) and the Matern VJP it feeds (kernels/covariance.py
// `_matern_bwd`) in the fused solver's backward (pallas_crout.py:315-353):
// per point it rebuilds C as H1 does, refactors it, solves w = C^{-1} xbar
// and contracts K2's packed cotangent gbar[i>=j] = -(w_i x_j + w_j x_i)
// (-w_i x_i on the diagonal) at once with dC/dsig2 = g(s) and dC/drho =
// sig2 g'(s) (-s/rho) over the valid pairs (double partial sums in both
// precisions); the diagonal gbar_jj of a valid response-conditioned slot is
// that slot's nugget cotangent.  No (n, P) array is written: the outputs
// are (n, 2) partial sums and (n, F) slot cotangents, which the wrapper
// reduces.
//
// What bounds them on an H100: work on the chip, not memory.  A point reads
// F neighbor ids, F*d coordinates and F masks (~0.5 KB at F=41, d=2) and
// does ~F^3/3 FMAs (~23k at F=41) and F(F+1)/2 covariance evaluations, so
// both sit far above the memory roofline.  They do not reach the FMA peak
// either: one warp walks a point's F pivots in order, a serial chain of a
// shuffle, a reciprocal square root and a shared-memory round trip each,
// and the lanes do the trailing update of their own rows only.  The limit
// is instruction issue under that chain and how many warps an SM holds
// (registers).
//
// Two routes, chosen by the wrapper by F and dtype alone (route() in
// kernels/matern_solve.py):
//  * the register route (matern_regs.cuh, instantiated in matern_regs_f32.cu
//    for F <= 64 and matern_regs_f64.cu for F <= 32): F padded with
//    identity slots to a multiple of 8, each lane's rows of C in registers,
//    C built into a packed triangle with the lanes spread evenly over the
//    pairs, one pivot-column store and 16-byte broadcasts a pivot (no
//    read-modify-write of the matrix in shared memory), L written once for
//    the backward substitution; H5 keeps dC/dsig2 and dC/drho from its
//    build, so its pair loop does no transcendental.  Details there.
//  * the shared-memory route (this file, above those F): one warp per point
//    (the batched-small-matrix layout of arXiv:2403.07412), the point's F x F
//    matrix in shared memory, column-major, lanes over rows, so every column
//    op is a conflict-free strided sweep; right-looking factorization, the
//    substitutions reuse the factor in place.  Shared memory per warp is
//    (F*F + F*d + 3F) values for H1 and (F*F + F*d + 4F) for H5 at the
//    closed forms, so the wrapper raises for F above the 48 KB per block
//    bound it states, on both routes; the general instances add their pair
//    list and H5's two derivative triangles (gen_warp_bytes), with dynamic
//    shared memory above 48 KB a block.
// Both routes take the covariance kind as a template parameter
// (matern_common.cuh): Closed, the closed forms at smoothness 0.5, 1.5 and
// 2.5, and General, the built-in Matern at any other smoothness
// (matern_solve_e0[general] and matern_solve_e0_bwd[general]).  General
// replaces, for that covariance, the JAX package's build_cov_packed + K3
// (gpvecchia_tpu/kernels/u_entries.py:296-320) and K2 with the Matern VJP
// (kernels/covariance.py:113-162): each pair's g(s) = exp(c0 + nu log s +
// log K_nu(s)) is evaluated in the kernel by the Temme / CF2 / climb
// algorithm of kernels/bessel.py from constants that depend on nu alone
// (computed once a launch on the host, one kernel parameter), and the
// backward adds dC/dnu from log K at nu + h and |nu - h| to the
// contraction (a third partial sum a point).  No (n, P) covariance is
// written.  What bounds General: the pairs' log K, whose cost depends on
// s: Temme's series at s <= 3 (5-16 terms at nu = 0.8, of 40, besides ~5
// transcendentals) or Steed's CF2 above (up to 64 steps of three
// divisions, fewer as s grows), and a warp pays for each branch any of its
// lanes takes, to its slowest lane.  So on the shared-memory route the
// general instances evaluate a per-point list of the pairs, the lanes
// spread evenly over it and the list sorted by branch and by s (the
// general pair pass below): only one warp pass a point runs both branches
// and a pass's lanes need about the same terms.  H5 evaluates each pair
// once (log K at nu with the climb's next ratio, nu + h, |nu - h|: three a
// pair) and keeps g, dg/ds and dg/dnu beside C for a contraction without
// transcendentals; the factor's pivot chain stays as above.
//
// Coordinates are gathered inside the kernels, so no (n, F(F+1)/2) distance
// array exists in device memory.  A non-SPD pivot is not clamped and the
// warp does not exit early: a negative pivot gives NaN and a zero pivot
// Inf, which poison only this point's row; the caller turns such rows into
// e0 and counts them.
//
// H8 solve_e0 replaces K3, `_solve_e0_kernel` (pallas_call at
// pallas_crout.py:140, `_solve_e0_impl`, entry `packed_solve_e0`): the
// same factor and solve as H1 on a packed covariance that the caller built
// (esqe, user covariances, a full covariance matrix, the general Matern
// above H1's bound on F).  Packed Cp (n, P) point-major, P = F(F+1)/2, row
// i of the upper triangle at [off_i, off_i + F - i), which is column i of
// the lower triangle.  H8 takes H1's two routes by the same rule: up to
// F = 64 in f32 and 32 in f64 the register route (matern_regs.cuh
// `h8_body`: the build step loads the packed row into the lane-spread
// triangle), above it this file's (one warp per point, the point's F x F
// matrix in shared memory, F*F + 2F values a warp, the unpack F contiguous
// slab reads).  What bounds it: like H1, the serial pivot chain of each
// warp, not memory: a point reads P values (3.4 KB at F=41 in f32) and does
// ~F^3/3 FMAs.  Non-SPD rows give NaN/Inf in their own row only.
//
// solve_e0_bwd is K2 itself, one to one: packed Cp (n, P), x and xbar
// (n, F) in, K2's packed gbar (n, P) out: H8's backward, on H8's routes
// (`k2_body` on the register route).

#include <cuda_runtime.h>
#include <stdint.h>

#include "matern_common.cuh"
#include "matern_regs.cuh"  // tri, tri_row: the register route's pair map

namespace {

using gpv::Closed;
using gpv::GenParams;
using gpv::General;
using gpv::gen_params;
using gpv::matern_corr;
using gpv::pair_dist;
using gpv::tri;
using gpv::tri_row;
using gpv::warp_sum;

// Gather point p's coordinates, validity (1/0) and diagonal nugget adds
// into the warp's shared memory.
template <typename T>
__device__ void gather(const T* __restrict__ locs, int d,
                       const int* __restrict__ NN,
                       const uint8_t* __restrict__ valid,
                       const uint8_t* __restrict__ resp,
                       const T* __restrict__ nug_point, long p, int F, T* pts,
                       T* dg, T* vf, int lane) {
  for (int i = lane; i < F; i += 32) {
    const int q = NN[p * F + i];
    const bool v = valid[p * F + i] != 0;
    for (int c = 0; c < d; ++c) pts[i * d + c] = locs[(long)q * d + c];
    vf[i] = v ? T(1) : T(0);
    dg[i] = (v && resp[p * F + i] != 0) ? nug_point[q] : T(0);
  }
  __syncwarp();
}

// Gather, then fill the lower triangle of C (column-major) a column at a
// time: response neighbors carry their nugget on the diagonal, invalid
// slots are identity-extended.
template <typename T, typename Cov>
__device__ void build_cov(const T* __restrict__ locs, int d,
                          const int* __restrict__ NN,
                          const uint8_t* __restrict__ valid,
                          const uint8_t* __restrict__ resp,
                          const T* __restrict__ nug_point, long p, int F,
                          T sig2, T rho, const Cov& cov, T* C, T* pts, T* dg,
                          T* vf, int lane) {
  gather(locs, d, NN, valid, resp, nug_point, p, F, pts, dg, vf, lane);
  for (int j = 0; j < F; ++j) {
    for (int i = j + lane; i < F; i += 32) {
      T val;
      if (vf[i] != T(0) && vf[j] != T(0)) {
        val = sig2 * matern_corr(cov, pair_dist(pts, i, j, d), rho,
                                 (T*)nullptr, (T*)nullptr);
        if (i == j) val += dg[j];
      } else {
        val = (i == j) ? T(1) : T(0);
      }
      C[j * F + i] = val;
    }
  }
  __syncwarp();
}

// right-looking Cholesky of C's lower triangle, in place; dg[k] = 1/L[k][k]
template <typename T>
__device__ void chol_inplace(T* C, T* dg, int F, int lane) {
  for (int k = 0; k < F; ++k) {
    const T inv = T(1) / sqrt(C[k * F + k]);   // no clamp: NaN/Inf propagate
    __syncwarp();
    if (lane == 0) dg[k] = inv;
    for (int i = k + lane; i < F; i += 32) C[k * F + i] *= inv;
    __syncwarp();
    for (int j = k + 1; j < F; ++j) {
      const T ljk = C[k * F + j];
      for (int i = j + lane; i < F; i += 32) C[j * F + i] -= C[k * F + i] * ljk;
    }
    __syncwarp();
  }
}

// b <- C^{-1} b with the factor of chol_inplace
template <typename T>
__device__ void solve_inplace(const T* C, const T* dg, T* b, int F,
                              int lane) {
  for (int k = 0; k < F; ++k) {              // forward: L y = b
    const T yk = b[k] * dg[k];
    __syncwarp();
    if (lane == 0) b[k] = yk;
    for (int i = k + 1 + lane; i < F; i += 32) b[i] -= C[k * F + i] * yk;
    __syncwarp();
  }
  for (int k = F - 1; k >= 0; --k) {         // backward: L^T x = y
    const T xk = b[k] * dg[k];
    __syncwarp();
    if (lane == 0) b[k] = xk;
    for (int i = lane; i < k; i += 32) b[i] -= C[i * F + k] * xk;
    __syncwarp();
  }
}

// ------------------------------------------------ the general pair pass
// The general Matern's pairs cost a log K_nu each, whose cost depends on s
// = dist / rho: Temme's series (up to 40 terms, more as s grows to 3) or
// Steed's CF2 above s = 3 (up to 64 steps, fewer as s grows).  A warp pays
// for every branch any of its lanes takes, each to its slowest lane, so
// the general instances do not walk C a column at a time.  Per point, with
// the lanes spread evenly over the strict lower triangle (pair k = (i, j),
// i > j, row by row): the diagonal and the pairs outside the list (an
// invalid slot, or dist 0: g = 1, dg/ds = dg/dnu = 0) get their entries at
// once, each listed pair's s goes into its own slot of C, and a counting
// sort by bin (a __match_any_sync a chunk of 32 pairs, twice) lists the
// pairs: Temme's bins of s first, then CF2's, each ordered by s.  The lanes
// then take the list 32 at a time, so only the chunk at the boundary runs
// both branches and a chunk's lanes need about the same terms or steps.
// Each pair's log K_nu arithmetic is log_kv's, unchanged.

constexpr unsigned FULL = 0xffffffffu;
constexpr int NBIN = 32;    // 16 bins of s <= 3 (and NaN), 16 above 3
static_assert(NBIN == 32, "the bins' scan takes one lane a bin");

__host__ __device__ constexpr size_t up16(size_t b) {
  return (b + 15) / 16 * 16;
}

// values a warp for the general instances beside the list: H1's C, pts, dg,
// vf, b; H5's C, dg/ds and dg/dnu triangles, pts, dg, vf, w, x
__host__ __device__ constexpr size_t gen_words(int F, int d, bool bwd) {
  return (size_t)F * F + (size_t)F * d + (bwd ? 4 : 3) * (size_t)F +
         (bwd ? (size_t)F * (F - 1) : 0);
}

// bytes a warp: the values, then the list (a membership bit a pair, the
// bins' counts, a 16-bit index a pair), each part 16-byte aligned;
// kernels/matern_solve.py `_smem_per_warp(..., general=True)` counts the
// same
template <typename T>
__host__ __device__ constexpr size_t gen_warp_bytes(int F, int d, bool bwd) {
  return up16(gen_words(F, d, bwd) * sizeof(T)) +
         up16(((size_t)(F * (F - 1) / 2 + 31) / 32 + NBIN) * 4) +
         up16((size_t)F * (F - 1));
}

struct PairList {
  unsigned* mask;     // a bit a pair: listed
  int* cnt;           // the bins' counts, then each bin's next slot
  uint16_t* idx;      // the listed pairs' k, bin by bin
};

template <typename T>
__device__ __forceinline__ PairList pair_list(unsigned char* base, int F,
                                              int d, bool bwd) {
  PairList L;
  L.mask = reinterpret_cast<unsigned*>(base +
                                       up16(gen_words(F, d, bwd) * sizeof(T)));
  L.cnt = reinterpret_cast<int*>(L.mask + (F * (F - 1) / 2 + 31) / 32);
  L.idx = reinterpret_cast<uint16_t*>(
      reinterpret_cast<unsigned char*>(L.mask) +
      up16(((size_t)(F * (F - 1) / 2 + 31) / 32 + NBIN) * 4));
  return L;
}

// pair k of the strict lower triangle, row by row
__device__ __forceinline__ void pair_ij(int k, int& i, int& j) {
  i = tri_row(k) + 1;
  j = k - tri(i - 1);
}

// the bin of s: the branch log_kv takes (CF2 above 3), then s in steps of
// 3/16 below 3 and of a quarter octave above it
template <typename T>
__device__ __forceinline__ int pair_bin(T s) {
  const float f = (float)s;
  if (s > T(3))
    return NBIN / 2 +
           min(max((int)(4.0f * __log2f(f * (1.0f / 3.0f))), 0), NBIN / 2 - 1);
  return min(max((int)(f * (NBIN / 2 / 3.0f)), 0), NBIN / 2 - 1);
}

// C's diagonal and the entries of the pairs outside the list, s in the
// listed pairs' slots of C, then the list; returns its length and sets
// n_temme, the length of its first part.  GRAD (H5): the unlisted valid
// pairs' g (C's upper triangle), dg/ds (Gd) and dg/dnu (Gn) too
template <typename T, bool GRAD>
__device__ int build_pair_list(const T* pts, const T* vf, const T* dg, int d,
                               int F, T sig2, T rho, T* C, T* Gd, T* Gn,
                               PairList L, int lane, int& n_temme) {
  const int P = F * (F - 1) / 2;
  for (int i = lane; i < F; i += 32)
    C[i * F + i] = vf[i] != T(0) ? sig2 + dg[i] : T(1);
  L.cnt[lane] = 0;
  __syncwarp();
  for (int k0 = 0; k0 < P; k0 += 32) {
    const int k = k0 + lane;
    int b = NBIN;                                // not listed
    if (k < P) {
      int i, j;
      pair_ij(k, i, j);
      T* c = C + j * F + i;
      if (vf[i] != T(0) && vf[j] != T(0)) {
        const T dist = pair_dist(pts, i, j, d);
        if (dist > T(0)) {
          *c = dist / rho;
          b = pair_bin(*c);
        } else {
          *c = sig2;
          if (GRAD) {
            C[i * F + j] = T(1);
            Gd[k] = T(0);
            Gn[k] = T(0);
          }
        }
      } else {
        *c = T(0);                               // identity-extended
      }
    }
    const unsigned listed = __ballot_sync(FULL, b < NBIN);
    const unsigned peers = __match_any_sync(FULL, b);
    if (lane == 0) L.mask[k0 >> 5] = listed;
    if (b < NBIN && lane == __ffs(peers) - 1) L.cnt[b] += __popc(peers);
    __syncwarp();
  }
  const int c = L.cnt[lane];                     // lane = bin
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  L.cnt[lane] = incl - c;
  n_temme = __shfl_sync(FULL, incl, NBIN / 2 - 1);
  const int total = __shfl_sync(FULL, incl, NBIN - 1);
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int k0 = 0; k0 < P; k0 += 32) {
    const int k = k0 + lane;
    int b = NBIN;
    if ((L.mask[k0 >> 5] >> lane) & 1u) {
      int i, j;
      pair_ij(k, i, j);
      b = pair_bin(C[j * F + i]);
    }
    const unsigned peers = __match_any_sync(FULL, b);
    if (b < NBIN) L.idx[L.cnt[b] + __popc(peers & below)] = (uint16_t)k;
    __syncwarp();
    if (b < NBIN && lane == __ffs(peers) - 1) L.cnt[b] += __popc(peers);
    __syncwarp();
  }
  return total;
}

// the engagement counts a launch adds to its stats, if given
// (kernels/matern_solve.py STATS_FIELDS): points, pairs on Temme's branch,
// pairs on CF2's, the list's warp passes, the column walk's warp passes
// over the same points (i >= j, a column a time), list passes that ran
// both branches
__device__ __forceinline__ void count_pairs(unsigned long long* stats, int F,
                                            int total, int n_temme,
                                            int lane) {
  if (stats == nullptr || lane != 0) return;
  int walk = 0;
  for (int m = 1; m <= F; ++m) walk += (m + 31) / 32;
  atomicAdd(stats, 1ull);
  atomicAdd(stats + 1, (unsigned long long)n_temme);
  atomicAdd(stats + 2, (unsigned long long)(total - n_temme));
  atomicAdd(stats + 3, (unsigned long long)((total + 31) / 32));
  atomicAdd(stats + 4, (unsigned long long)walk);
  if (n_temme % 32 != 0 && n_temme < total) atomicAdd(stats + 5, 1ull);
}

template <typename T>
__device__ __forceinline__ void h1_general_body(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho,
    const General<T>& cov, T* __restrict__ x,
    unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* base = smem_raw + warp * gen_warp_bytes<T>(F, d, false);
  T* C = reinterpret_cast<T*>(base);       // listed pairs: s, then C
  T* pts = C + F * F;
  T* dg = pts + F * d;
  T* vf = dg + F;
  T* b = vf + F;
  const PairList L = pair_list<T>(base, F, d, false);
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;                      // whole warp leaves together

  for (int i = lane; i < F; i += 32) b[i] = (i == 0) ? T(1) : T(0);
  gather(locs, d, NN, valid, resp, nug_point, p, F, pts, dg, vf, lane);
  int n_temme;
  const int total = build_pair_list<T, false>(
      pts, vf, dg, d, F, sig2, rho, C, nullptr, nullptr, L, lane, n_temme);
  for (int t = lane; t < total; t += 32) {
    int i, j;
    pair_ij(L.idx[t], i, j);
    T* c = C + j * F + i;
    *c = sig2 * cov.value(*c);
  }
  count_pairs(stats, F, total, n_temme, lane);
  __syncwarp();
  chol_inplace(C, dg, F, lane);
  solve_inplace(C, dg, b, F, lane);
  for (int i = lane; i < F; i += 32) x[p * F + i] = b[i];
}

template <typename T, typename Cov>
__device__ __forceinline__ void h1_shared_body(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho,
    const Cov& cov, T* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* C = smem + (size_t)warp * (F * F + F * d + 3 * F);
  T* pts = C + F * F;                      // (F, d) coordinates
  T* dg = pts + F * d;                     // nugget adds, then 1/L[k][k]
  T* vf = dg + F;                          // 1 = valid slot
  T* b = vf + F;                           // right-hand side / solution
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;                      // whole warp leaves together

  for (int i = lane; i < F; i += 32) b[i] = (i == 0) ? T(1) : T(0);
  build_cov(locs, d, NN, valid, resp, nug_point, p, F, sig2, rho, cov, C,
            pts, dg, vf, lane);
  chol_inplace(C, dg, F, lane);
  solve_inplace(C, dg, b, F, lane);
  for (int i = lane; i < F; i += 32) x[p * F + i] = b[i];
}

#define GPV_SH_PARAMS                                                      \
  const T *__restrict__ locs, int d, const int *__restrict__ NN,           \
      const uint8_t *__restrict__ valid, const uint8_t *__restrict__ resp, \
      const T *__restrict__ nug_point, int n, int F, T sig2, T rho
#define GPV_SH_ARGS locs, d, NN, valid, resp, nug_point, n, F, sig2, rho

template <typename T>
__global__ void matern_solve_e0_kernel(GPV_SH_PARAMS, int nu_idx,
                                       T* __restrict__ x) {
  h1_shared_body(GPV_SH_ARGS, Closed<T>{nu_idx}, x);
}

template <typename T>
__global__ void matern_solve_e0_gen_kernel(GPV_SH_PARAMS,
                                           const GenParams<T> gp,
                                           T* __restrict__ x,
                                           unsigned long long* stats) {
  h1_general_body(GPV_SH_ARGS, General<T>{gp}, x, stats);
}

// the closed forms: two partial sums a point (sig2, rho)
template <typename T, typename Cov>
__device__ __forceinline__ void h5_shared_body(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho,
    const Cov& cov, const T* __restrict__ x, const T* __restrict__ xbar,
    double* __restrict__ dpar, T* __restrict__ dslot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* C = smem + (size_t)warp * (F * F + F * d + 4 * F);
  T* pts = C + F * F;
  T* dg = pts + F * d;
  T* vf = dg + F;
  T* w = vf + F;                           // xbar, then w = C^{-1} xbar
  T* xs = w + F;                           // the forward's x
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;

  for (int i = lane; i < F; i += 32) {
    w[i] = xbar[p * F + i];
    xs[i] = x[p * F + i];
  }
  build_cov(locs, d, NN, valid, resp, nug_point, p, F, sig2, rho, cov, C,
            pts, dg, vf, lane);
  chol_inplace(C, dg, F, lane);
  solve_inplace(C, dg, w, F, lane);

  // K2's packed cotangent, contracted pair by pair (i >= j) with dC/dsig2
  // and dC/drho, recomputed here; the partial sums are kept in double, so a
  // float32 run loses no digits in them
  double a_sig2 = 0.0, a_rho = 0.0;
  for (int j = 0; j < F; ++j) {
    for (int i = j + lane; i < F; i += 32) {
      if (vf[i] == T(0) || vf[j] == T(0)) continue;  // identity-extended
      const T g = (i == j) ? -w[i] * xs[i] : -(w[i] * xs[j] + w[j] * xs[i]);
      const T dist = pair_dist(pts, i, j, d);
      T dgds, dgdnu;
      const T corr = matern_corr(cov, dist, rho, &dgds, &dgdnu);
      a_sig2 += (double)(g * corr);
      a_rho += (double)(g * sig2 * dgds * (-(dist / rho) / rho));
    }
  }
  for (int j = lane; j < F; j += 32)
    dslot[p * F + j] = (vf[j] != T(0) && resp[p * F + j] != 0)
                           ? -w[j] * xs[j] : T(0);
  a_sig2 = warp_sum(a_sig2);
  a_rho = warp_sum(a_rho);
  if (lane == 0) {
    dpar[p * 2] = a_sig2;
    dpar[p * 2 + 1] = a_rho;
  }
}

// The general Matern's backward: one pass over the list evaluates each
// pair's g, dg/ds and dg/dnu (log K_nu at nu, with the climb's next ratio,
// nu + h and |nu - h|) and keeps them beside C, g in C's upper triangle;
// the contraction then reads them, with the lanes spread evenly over the
// packed triangle, and runs no transcendental.  Three partial sums a point
// (sig2, rho, nu).
template <typename T>
__device__ __forceinline__ void h5_general_body(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho,
    const General<T>& cov, const T* __restrict__ x,
    const T* __restrict__ xbar, double* __restrict__ dpar,
    T* __restrict__ dslot, unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* base = smem_raw + warp * gen_warp_bytes<T>(F, d, true);
  const int P = F * (F - 1) / 2;
  T* C = reinterpret_cast<T*>(base);       // lower: s, then C; upper: g
  T* Gd = C + F * F;                       // dg/ds, pair k at k
  T* Gn = Gd + P;                          // dg/dnu
  T* pts = Gn + P;
  T* dg = pts + F * d;
  T* vf = dg + F;
  T* w = vf + F;                           // xbar, then w = C^{-1} xbar
  T* xs = w + F;                           // the forward's x
  const PairList L = pair_list<T>(base, F, d, true);
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;

  for (int i = lane; i < F; i += 32) {
    w[i] = xbar[p * F + i];
    xs[i] = x[p * F + i];
  }
  gather(locs, d, NN, valid, resp, nug_point, p, F, pts, dg, vf, lane);
  int n_temme;
  const int total = build_pair_list<T, true>(pts, vf, dg, d, F, sig2, rho,
                                             C, Gd, Gn, L, lane, n_temme);
  for (int t = lane; t < total; t += 32) {
    const int k = L.idx[t];
    int i, j;
    pair_ij(k, i, j);
    T dgds, dgdnu;
    const T g = cov.grad(C[j * F + i], &dgds, &dgdnu);
    C[j * F + i] = sig2 * g;
    C[i * F + j] = g;
    Gd[k] = dgds;
    Gn[k] = dgdnu;
  }
  count_pairs(stats, F, total, n_temme, lane);
  __syncwarp();
  chol_inplace(C, dg, F, lane);
  solve_inplace(C, dg, w, F, lane);

  // K2's packed cotangent gbar[i >= j] = -(w_i x_j + w_j x_i) (-w_i x_i on
  // the diagonal), contracted pair by pair with dC/dsig2 = g, dC/drho =
  // sig2 g'(s) (-s / rho) and dC/dnu = sig2 dg/dnu over the valid pairs,
  // each term as matern_corr's at dist 0 and as the build's elsewhere; the
  // partial sums are kept in double, so a float32 run loses no digits
  double a_sig2 = 0.0, a_rho = 0.0, a_nu = 0.0;
  for (int q = lane; q < tri(F); q += 32) {
    const int i = tri_row(q), j = q - tri(i);
    if (vf[i] == T(0) || vf[j] == T(0)) continue;  // identity-extended
    const T g = (i == j) ? -w[i] * xs[i] : -(w[i] * xs[j] + w[j] * xs[i]);
    const T dist = pair_dist(pts, i, j, d);
    T corr = T(1), dgds = T(0), dgdnu = T(0);
    if (i != j) {
      const int k = tri(i - 1) + j;
      corr = C[i * F + j];
      dgds = Gd[k];
      dgdnu = Gn[k];
    }
    a_sig2 += (double)(g * corr);
    a_rho += (double)(g * sig2 * dgds * (-(dist / rho) / rho));
    a_nu += (double)(g * sig2 * dgdnu);
  }
  for (int j = lane; j < F; j += 32)
    dslot[p * F + j] = (vf[j] != T(0) && resp[p * F + j] != 0)
                           ? -w[j] * xs[j] : T(0);
  a_sig2 = warp_sum(a_sig2);
  a_rho = warp_sum(a_rho);
  a_nu = warp_sum(a_nu);
  if (lane == 0) {
    dpar[p * 3] = a_sig2;
    dpar[p * 3 + 1] = a_rho;
    dpar[p * 3 + 2] = a_nu;
  }
}

#define GPV_SH5_PARAMS                                  \
  const T *__restrict__ x, const T *__restrict__ xbar, \
      double *__restrict__ dpar, T *__restrict__ dslot
#define GPV_SH5_ARGS x, xbar, dpar, dslot

template <typename T>
__global__ void matern_solve_e0_bwd_kernel(GPV_SH_PARAMS, int nu_idx,
                                           GPV_SH5_PARAMS) {
  h5_shared_body(GPV_SH_ARGS, Closed<T>{nu_idx}, GPV_SH5_ARGS);
}

template <typename T>
__global__ void matern_solve_e0_bwd_gen_kernel(GPV_SH_PARAMS,
                                               const GenParams<T> gp,
                                               GPV_SH5_PARAMS,
                                               unsigned long long* stats) {
  h5_general_body(GPV_SH_ARGS, General<T>{gp}, GPV_SH5_ARGS, stats);
}

// packed row j of the upper triangle is column j of the lower one
template <typename T>
__device__ void unpack_lower(const T* __restrict__ cp, T* C, int F,
                             int lane) {
  for (int j = 0, off = 0; j < F; off += F - j, ++j)
    for (int i = j + lane; i < F; i += 32) C[j * F + i] = cp[off + i - j];
  __syncwarp();
}

template <typename T>
__global__ void solve_e0_kernel(const T* __restrict__ Cp, int n, int F,
                                T* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* C = smem + (size_t)warp * (F * F + 2 * F);
  T* dg = C + F * F;                       // 1/L[k][k]
  T* b = dg + F;                           // e0, then the solution
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;                      // whole warp leaves together
  const long P = (long)F * (F + 1) / 2;

  for (int i = lane; i < F; i += 32) b[i] = (i == 0) ? T(1) : T(0);
  unpack_lower(Cp + p * P, C, F, lane);
  chol_inplace(C, dg, F, lane);
  solve_inplace(C, dg, b, F, lane);
  for (int i = lane; i < F; i += 32) x[p * F + i] = b[i];
}

template <typename T>
__global__ void solve_e0_bwd_kernel(const T* __restrict__ Cp, int n, int F,
                                    const T* __restrict__ x,
                                    const T* __restrict__ xbar,
                                    T* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* C = smem + (size_t)warp * (F * F + 3 * F);
  T* dg = C + F * F;
  T* w = dg + F;
  T* xs = w + F;
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;
  const long P = (long)F * (F + 1) / 2;
  const T* cp = Cp + p * P;
  T* gp = g + p * P;

  for (int i = lane; i < F; i += 32) {
    w[i] = xbar[p * F + i];
    xs[i] = x[p * F + i];
  }
  unpack_lower(cp, C, F, lane);
  chol_inplace(C, dg, F, lane);
  solve_inplace(C, dg, w, F, lane);
  for (int i = 0, off = 0; i < F; off += F - i, ++i)
    for (int j = i + lane; j < F; j += 32)
      gp[off + j - i] = (j == i) ? -w[i] * xs[i]
                                 : -(w[i] * xs[j] + w[j] * xs[i]);
}

// a block of the general instances may take more than 48 KB: the larger
// dynamic size is allowed first
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// gen: null at a closed form (nu_idx), else the general Matern's host
// constants (kernels/matern_solve.py `general_params`); stats: null, or
// STATS counts the general instances add to (count_pairs)
template <typename T>
int launch_matern_solve_e0(const T* locs, int d, const int* NN,
                           const uint8_t* valid, const uint8_t* resp,
                           const T* nug_point, int n, int F, double sig2,
                           double rho, int nu_idx, const double* gen, T* x,
                           unsigned long long* stats, int warps_per_block,
                           cudaStream_t stream) {
  if (n == 0) return 0;
  const int blocks = (n + warps_per_block - 1) / warps_per_block;
  if (gen) {
    const size_t smem = warps_per_block * gen_warp_bytes<T>(F, d, false);
    const int rc = allow_smem(matern_solve_e0_gen_kernel<T>, smem);
    if (rc != 0) return rc;
    matern_solve_e0_gen_kernel<T>
        <<<blocks, 32 * warps_per_block, smem, stream>>>(
            locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho,
            gen_params<T>(gen), x, stats);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)warps_per_block * (F * F + F * d + 3 * F) * sizeof(T);
  matern_solve_e0_kernel<T><<<blocks, 32 * warps_per_block, smem, stream>>>(
      locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho, nu_idx, x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_matern_solve_e0_bwd(const T* locs, int d, const int* NN,
                               const uint8_t* valid, const uint8_t* resp,
                               const T* nug_point, int n, int F, double sig2,
                               double rho, int nu_idx, const double* gen,
                               const T* x, const T* xbar, double* dpar,
                               T* dslot, unsigned long long* stats,
                               int warps_per_block, cudaStream_t stream) {
  if (n == 0) return 0;
  const int blocks = (n + warps_per_block - 1) / warps_per_block;
  if (gen) {
    const size_t smem = warps_per_block * gen_warp_bytes<T>(F, d, true);
    const int rc = allow_smem(matern_solve_e0_bwd_gen_kernel<T>, smem);
    if (rc != 0) return rc;
    matern_solve_e0_bwd_gen_kernel<T>
        <<<blocks, 32 * warps_per_block, smem, stream>>>(
            locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho,
            gen_params<T>(gen), x, xbar, dpar, dslot, stats);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)warps_per_block * (F * F + F * d + 4 * F) * sizeof(T);
  matern_solve_e0_bwd_kernel<T>
      <<<blocks, 32 * warps_per_block, smem, stream>>>(
          locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho,
          nu_idx, x, xbar, dpar, dslot);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve_e0(const T* Cp, int n, int F, T* x, int warps_per_block,
                    cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t smem = (size_t)warps_per_block * (F * F + 2 * F) * sizeof(T);
  const int blocks = (n + warps_per_block - 1) / warps_per_block;
  solve_e0_kernel<T><<<blocks, 32 * warps_per_block, smem, stream>>>(Cp, n,
                                                                     F, x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve_e0_bwd(const T* Cp, int n, int F, const T* x, const T* xbar,
                        T* g, int warps_per_block, cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t smem = (size_t)warps_per_block * (F * F + 3 * F) * sizeof(T);
  const int blocks = (n + warps_per_block - 1) / warps_per_block;
  solve_e0_bwd_kernel<T><<<blocks, 32 * warps_per_block, smem, stream>>>(
      Cp, n, F, x, xbar, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gpv_matern_solve_e0_f32(const float* locs, int d, const int* NN,
                            const uint8_t* valid, const uint8_t* resp,
                            const float* nug_point, int n, int F, double sig2,
                            double rho, int nu_idx, const double* gen,
                            float* x, unsigned long long* stats,
                            int warps_per_block, void* stream) {
  return launch_matern_solve_e0<float>(locs, d, NN, valid, resp, nug_point, n,
                                       F, sig2, rho, nu_idx, gen, x, stats,
                                       warps_per_block, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_f64(const double* locs, int d, const int* NN,
                            const uint8_t* valid, const uint8_t* resp,
                            const double* nug_point, int n, int F,
                            double sig2, double rho, int nu_idx,
                            const double* gen, double* x,
                            unsigned long long* stats, int warps_per_block,
                            void* stream) {
  return launch_matern_solve_e0<double>(locs, d, NN, valid, resp, nug_point,
                                        n, F, sig2, rho, nu_idx, gen, x, stats,
                                        warps_per_block, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_f32(const float* locs, int d, const int* NN,
                                const uint8_t* valid, const uint8_t* resp,
                                const float* nug_point, int n, int F,
                                double sig2, double rho, int nu_idx,
                                const double* gen, const float* x,
                                const float* xbar,
                                double* dpar, float* dslot,
                                unsigned long long* stats,
                                int warps_per_block, void* stream) {
  return launch_matern_solve_e0_bwd<float>(
      locs, d, NN, valid, resp, nug_point, n, F, sig2, rho, nu_idx, gen, x,
      xbar, dpar, dslot, stats, warps_per_block, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_f64(const double* locs, int d, const int* NN,
                                const uint8_t* valid, const uint8_t* resp,
                                const double* nug_point, int n, int F,
                                double sig2, double rho, int nu_idx,
                                const double* gen, const double* x,
                                const double* xbar,
                                double* dpar, double* dslot,
                                unsigned long long* stats,
                                int warps_per_block, void* stream) {
  return launch_matern_solve_e0_bwd<double>(
      locs, d, NN, valid, resp, nug_point, n, F, sig2, rho, nu_idx, gen, x,
      xbar, dpar, dslot, stats, warps_per_block, (cudaStream_t)stream);
}

int gpv_solve_e0_f32(const float* Cp, int n, int F, float* x,
                     int warps_per_block, void* stream) {
  return launch_solve_e0<float>(Cp, n, F, x, warps_per_block,
                                (cudaStream_t)stream);
}

int gpv_solve_e0_f64(const double* Cp, int n, int F, double* x,
                     int warps_per_block, void* stream) {
  return launch_solve_e0<double>(Cp, n, F, x, warps_per_block,
                                 (cudaStream_t)stream);
}

int gpv_solve_e0_bwd_f32(const float* Cp, int n, int F, const float* x,
                         const float* xbar, float* g, int warps_per_block,
                         void* stream) {
  return launch_solve_e0_bwd<float>(Cp, n, F, x, xbar, g, warps_per_block,
                                    (cudaStream_t)stream);
}

int gpv_solve_e0_bwd_f64(const double* Cp, int n, int F, const double* x,
                         const double* xbar, double* g, int warps_per_block,
                         void* stream) {
  return launch_solve_e0_bwd<double>(Cp, n, F, x, xbar, g, warps_per_block,
                                     (cudaStream_t)stream);
}

const char* gpv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
