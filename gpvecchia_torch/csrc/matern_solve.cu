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
//    (F*F + F*d + 3F) values for H1 and (F*F + F*d + 4F) for H5, so the
//    wrapper raises for F above the 48 KB per block bound it states, on both
//    routes.
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
// written.  What bounds General: the pairs' arithmetic, ~500 instructions
// a pair for log K on Temme's branch (40 terms, 5 transcendentals), ~3x
// that in the backward; the factor's pivot chain stays as above.
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

namespace {

using gpv::Closed;
using gpv::GenParams;
using gpv::General;
using gpv::gen_params;
using gpv::matern_corr;
using gpv::pair_dist;
using gpv::warp_sum;

// Gather point p's coordinates, validity and diagonal nugget adds into the
// warp's shared memory, then fill the lower triangle of C (column-major):
// response neighbors carry their nugget on the diagonal, invalid slots are
// identity-extended.
template <typename T, typename Cov>
__device__ void build_cov(const T* __restrict__ locs, int d,
                          const int* __restrict__ NN,
                          const uint8_t* __restrict__ valid,
                          const uint8_t* __restrict__ resp,
                          const T* __restrict__ nug_point, long p, int F,
                          T sig2, T rho, const Cov& cov, T* C, T* pts, T* dg,
                          T* vf, int lane) {
  for (int i = lane; i < F; i += 32) {
    const int q = NN[p * F + i];
    const bool v = valid[p * F + i] != 0;
    for (int c = 0; c < d; ++c) pts[i * d + c] = locs[(long)q * d + c];
    vf[i] = v ? T(1) : T(0);
    dg[i] = (v && resp[p * F + i] != 0) ? nug_point[q] : T(0);
  }
  __syncwarp();
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
                                           T* __restrict__ x) {
  h1_shared_body(GPV_SH_ARGS, General<T>{gp}, x);
}

// NPAR = 2 partial sums a point (sig2, rho) at the closed forms, 3 (with
// nu) for the general Matern
template <typename T, typename Cov>
__device__ __forceinline__ void h5_shared_body(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho,
    const Cov& cov, const T* __restrict__ x, const T* __restrict__ xbar,
    double* __restrict__ dpar, T* __restrict__ dslot) {
  constexpr bool GEN = Cov::kGeneral;
  constexpr int NPAR = GEN ? 3 : 2;
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

  // K2's packed cotangent, contracted pair by pair (i >= j) with dC/dsig2,
  // dC/drho (and dC/dnu), recomputed here; the partial sums are kept in
  // double, so a float32 run loses no digits in them
  double a_sig2 = 0.0, a_rho = 0.0, a_nu = 0.0;
  for (int j = 0; j < F; ++j) {
    for (int i = j + lane; i < F; i += 32) {
      if (vf[i] == T(0) || vf[j] == T(0)) continue;  // identity-extended
      const T g = (i == j) ? -w[i] * xs[i] : -(w[i] * xs[j] + w[j] * xs[i]);
      const T dist = pair_dist(pts, i, j, d);
      T dgds, dgdnu;
      const T corr = matern_corr(cov, dist, rho, &dgds, &dgdnu);
      a_sig2 += (double)(g * corr);
      a_rho += (double)(g * sig2 * dgds * (-(dist / rho) / rho));
      if (GEN) a_nu += (double)(g * sig2 * dgdnu);
    }
  }
  for (int j = lane; j < F; j += 32)
    dslot[p * F + j] = (vf[j] != T(0) && resp[p * F + j] != 0)
                           ? -w[j] * xs[j] : T(0);
  a_sig2 = warp_sum(a_sig2);
  a_rho = warp_sum(a_rho);
  if (GEN) a_nu = warp_sum(a_nu);
  if (lane == 0) {
    dpar[p * NPAR] = a_sig2;
    dpar[p * NPAR + 1] = a_rho;
    if (GEN) dpar[p * NPAR + 2] = a_nu;
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
                                               GPV_SH5_PARAMS) {
  h5_shared_body(GPV_SH_ARGS, General<T>{gp}, GPV_SH5_ARGS);
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

// gen: null at a closed form (nu_idx), else the general Matern's
// host constants (kernels/matern_solve.py `general_params`)
template <typename T>
int launch_matern_solve_e0(const T* locs, int d, const int* NN,
                           const uint8_t* valid, const uint8_t* resp,
                           const T* nug_point, int n, int F, double sig2,
                           double rho, int nu_idx, const double* gen, T* x,
                           int warps_per_block, cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t smem =
      (size_t)warps_per_block * (F * F + F * d + 3 * F) * sizeof(T);
  const int blocks = (n + warps_per_block - 1) / warps_per_block;
  if (gen)
    matern_solve_e0_gen_kernel<T>
        <<<blocks, 32 * warps_per_block, smem, stream>>>(
            locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho,
            gen_params<T>(gen), x);
  else
    matern_solve_e0_kernel<T><<<blocks, 32 * warps_per_block, smem, stream>>>(
        locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho, nu_idx,
        x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_matern_solve_e0_bwd(const T* locs, int d, const int* NN,
                               const uint8_t* valid, const uint8_t* resp,
                               const T* nug_point, int n, int F, double sig2,
                               double rho, int nu_idx, const double* gen,
                               const T* x, const T* xbar, double* dpar,
                               T* dslot, int warps_per_block,
                               cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t smem =
      (size_t)warps_per_block * (F * F + F * d + 4 * F) * sizeof(T);
  const int blocks = (n + warps_per_block - 1) / warps_per_block;
  if (gen)
    matern_solve_e0_bwd_gen_kernel<T>
        <<<blocks, 32 * warps_per_block, smem, stream>>>(
            locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho,
            gen_params<T>(gen), x, xbar, dpar, dslot);
  else
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
                            float* x, int warps_per_block, void* stream) {
  return launch_matern_solve_e0<float>(locs, d, NN, valid, resp, nug_point, n,
                                       F, sig2, rho, nu_idx, gen, x,
                                       warps_per_block, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_f64(const double* locs, int d, const int* NN,
                            const uint8_t* valid, const uint8_t* resp,
                            const double* nug_point, int n, int F,
                            double sig2, double rho, int nu_idx,
                            const double* gen, double* x,
                            int warps_per_block, void* stream) {
  return launch_matern_solve_e0<double>(locs, d, NN, valid, resp, nug_point,
                                        n, F, sig2, rho, nu_idx, gen, x,
                                        warps_per_block, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_f32(const float* locs, int d, const int* NN,
                                const uint8_t* valid, const uint8_t* resp,
                                const float* nug_point, int n, int F,
                                double sig2, double rho, int nu_idx,
                                const double* gen, const float* x,
                                const float* xbar,
                                double* dpar, float* dslot,
                                int warps_per_block, void* stream) {
  return launch_matern_solve_e0_bwd<float>(
      locs, d, NN, valid, resp, nug_point, n, F, sig2, rho, nu_idx, gen, x,
      xbar, dpar, dslot, warps_per_block, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_f64(const double* locs, int d, const int* NN,
                                const uint8_t* valid, const uint8_t* resp,
                                const double* nug_point, int n, int F,
                                double sig2, double rho, int nu_idx,
                                const double* gen, const double* x,
                                const double* xbar,
                                double* dpar, double* dslot,
                                int warps_per_block, void* stream) {
  return launch_matern_solve_e0_bwd<double>(
      locs, d, NN, valid, resp, nug_point, n, F, sig2, rho, nu_idx, gen, x,
      xbar, dpar, dslot, warps_per_block, (cudaStream_t)stream);
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
