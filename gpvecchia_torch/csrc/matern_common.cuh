// Device helpers shared by the two routes of H1 and H5
// (matern_solve.cu: shared-memory route; matern_regs.cuh: register route).

#pragma once

#include <cuda_runtime.h>

namespace gpv {

// exp; with FAST in float32 the hardware's approximate exp2 (2 ulp near 0,
// growing with |x|; the values it loses digits on are below e^-20)
template <bool FAST, typename T>
__device__ __forceinline__ T exp_(T x) {
  return exp(x);
}
template <>
__device__ __forceinline__ float exp_<true, float>(float x) {
  return __expf(x);
}

// g(s) and dg/ds of the closed-form Matern correlation at s > 0
// (kernels/covariance.py `_correlation` and `matern_dgds`)
template <typename T, bool FAST = false>
__device__ __forceinline__ T matern_g(T s, int nu_idx, T* dgds) {
  if (nu_idx == 0) {
    const T e = exp_<FAST>(-s);
    if (dgds) *dgds = -e;
    return e;
  }
  if (nu_idx == 1) {
    const T r3 = T(1.7320508075688772);
    const T e = exp_<FAST>(-r3 * s);
    if (dgds) *dgds = T(-3) * s * e;
    return (T(1) + r3 * s) * e;
  }
  const T r5 = T(2.2360679774997896);
  const T e = exp_<FAST>(-r5 * s);
  if (dgds) *dgds = -(T(5) / T(3)) * s * (T(1) + r5 * s) * e;
  return (T(1) + r5 * s + T(5) * s * s / T(3)) * e;
}

// g and dg/ds at s = dist / rho; g = 1 and dg/ds = 0 at dist == 0
template <typename T>
__device__ __forceinline__ T matern_corr(T dist, T rho, int nu_idx, T* dgds) {
  if (!(dist > T(0))) {
    if (dgds) *dgds = T(0);
    return T(1);
  }
  return matern_g(dist / rho, nu_idx, dgds);
}

template <typename T>
__device__ __forceinline__ T pair_dist(const T* pts, int i, int j, int d) {
  T d2 = T(0);
  for (int c = 0; c < d; ++c) {
    const T t = pts[i * d + c] - pts[j * d + c];
    d2 += t * t;
  }
  return d2 > T(0) ? sqrt(d2) : T(0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace gpv
