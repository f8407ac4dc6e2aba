// H1 matern_solve_e0: per point, the closed-form Matern covariance of its
// conditioning set, its Cholesky factor, and x = C^{-1} e0.
//
// Replaces the TPU kernel gpvecchia_tpu/kernels/pallas_crout.py
// `_fused_kernel` (pallas_call at :268, entry `fused_matern_solve`), whose
// body builds the packed covariance from transposed caches, factors it and
// solves against e0 with the point batch on the 128-wide lane axis.
//
// What bounds it on an H100: work on the chip, not memory.  A point reads F
// neighbor ids, F*d coordinates and F masks (~0.5 KB at F=41, d=2) and does
// ~F^3/3 FMAs (~23k at F=41), so the kernel sits far above the memory
// roofline.  It does not reach the FMA peak either: at n=1e6, F=41 in f32
// it runs ~1 TFLOP/s by that count (H100 80GB HBM3, 700 W), because one
// warp walks the F pivots in order with a __syncwarp per step and only the
// F-k lanes below pivot k have work.  The limit is this serial chain per
// point and how many points are in flight.
//
// Design: one warp per point (the batched-small-matrix layout of
// arXiv:2403.07412).  The point's F x F matrix lives in shared memory,
// column-major, lanes over rows, so every column op is a conflict-free
// strided sweep.  Coordinates are gathered inside the kernel, so no
// (n, F(F+1)/2) distance array exists in device memory.  The factorization
// is right-looking; the forward and backward substitutions against e0 reuse
// the factor in place.  A non-SPD pivot is not clamped and the warp does not
// exit early: sqrt of a negative pivot is NaN and a zero pivot gives Inf,
// which poison only this point's row; the caller turns such rows into e0
// and counts them.  Shared memory per warp is (F*F + F*d + 3F) values, so
// the wrapper raises for F above the 48 KB-per-block bound it states.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T matern_closed(T dist, T sig2, T rho, int nu_idx) {
  // sig2 * where(dist > 0, g(dist / rho), 1), as kernels/covariance.py
  if (!(dist > T(0))) return sig2;
  const T s = dist / rho;
  T c;
  if (nu_idx == 0) {
    c = exp(-s);
  } else if (nu_idx == 1) {
    const T r3 = T(1.7320508075688772);
    c = (T(1) + r3 * s) * exp(-r3 * s);
  } else {
    const T r5 = T(2.2360679774997896);
    c = (T(1) + r5 * s + T(5) * s * s / T(3)) * exp(-r5 * s);
  }
  return sig2 * c;
}

template <typename T>
__global__ void matern_solve_e0_kernel(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho, int nu_idx,
    T* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = F * F + F * d + 3 * F;
  T* C = smem + (size_t)warp * per_warp;   // column-major, lower triangle
  T* pts = C + F * F;                      // (F, d) coordinates
  T* dg = pts + F * d;                     // nugget adds, then 1/L[k][k]
  T* vf = dg + F;                          // 1 = valid slot
  T* b = vf + F;                           // right-hand side / solution
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;                      // whole warp leaves together

  for (int i = lane; i < F; i += 32) {
    const int q = NN[p * F + i];
    const bool v = valid[p * F + i] != 0;
    for (int c = 0; c < d; ++c) pts[i * d + c] = locs[(long)q * d + c];
    vf[i] = v ? T(1) : T(0);
    dg[i] = (v && resp[p * F + i] != 0) ? nug_point[q] : T(0);
    b[i] = (i == 0) ? T(1) : T(0);
  }
  __syncwarp();

  // covariance (response neighbors carry their nugget on the diagonal,
  // invalid slots are identity-extended)
  for (int j = 0; j < F; ++j) {
    for (int i = j + lane; i < F; i += 32) {
      T val;
      if (vf[i] != T(0) && vf[j] != T(0)) {
        T d2 = T(0);
        for (int c = 0; c < d; ++c) {
          const T t = pts[i * d + c] - pts[j * d + c];
          d2 += t * t;
        }
        const T dist = d2 > T(0) ? sqrt(d2) : T(0);
        val = matern_closed(dist, sig2, rho, nu_idx);
        if (i == j) val += dg[j];
      } else {
        val = (i == j) ? T(1) : T(0);
      }
      C[j * F + i] = val;
    }
  }
  __syncwarp();

  // right-looking Cholesky, in place
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

  // forward: L y = e0
  for (int k = 0; k < F; ++k) {
    const T yk = b[k] * dg[k];
    __syncwarp();
    if (lane == 0) b[k] = yk;
    for (int i = k + 1 + lane; i < F; i += 32) b[i] -= C[k * F + i] * yk;
    __syncwarp();
  }
  // backward: L^T x = y
  for (int k = F - 1; k >= 0; --k) {
    const T xk = b[k] * dg[k];
    __syncwarp();
    if (lane == 0) b[k] = xk;
    for (int i = lane; i < k; i += 32) b[i] -= C[i * F + k] * xk;
    __syncwarp();
  }
  for (int i = lane; i < F; i += 32) x[p * F + i] = b[i];
}

template <typename T>
int launch_matern_solve_e0(const T* locs, int d, const int* NN,
                           const uint8_t* valid, const uint8_t* resp,
                           const T* nug_point, int n, int F, double sig2,
                           double rho, int nu_idx, T* x,
                           int warps_per_block, cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t smem =
      (size_t)warps_per_block * (F * F + F * d + 3 * F) * sizeof(T);
  const int blocks = (n + warps_per_block - 1) / warps_per_block;
  matern_solve_e0_kernel<T><<<blocks, 32 * warps_per_block, smem, stream>>>(
      locs, d, NN, valid, resp, nug_point, n, F, (T)sig2, (T)rho, nu_idx, x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gpv_matern_solve_e0_f32(const float* locs, int d, const int* NN,
                            const uint8_t* valid, const uint8_t* resp,
                            const float* nug_point, int n, int F, double sig2,
                            double rho, int nu_idx, float* x,
                            int warps_per_block, void* stream) {
  return launch_matern_solve_e0<float>(locs, d, NN, valid, resp, nug_point, n,
                                       F, sig2, rho, nu_idx, x,
                                       warps_per_block, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_f64(const double* locs, int d, const int* NN,
                            const uint8_t* valid, const uint8_t* resp,
                            const double* nug_point, int n, int F,
                            double sig2, double rho, int nu_idx, double* x,
                            int warps_per_block, void* stream) {
  return launch_matern_solve_e0<double>(locs, d, NN, valid, resp, nug_point,
                                        n, F, sig2, rho, nu_idx, x,
                                        warps_per_block, (cudaStream_t)stream);
}

const char* gpv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
