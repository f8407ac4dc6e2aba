// H1 matern_solve_e0 and H5 matern_solve_e0_bwd, register route: each
// point's conditioning matrix lives in its warp's registers.  The design
// note, the routes and what bounds them are at the head of matern_solve.cu;
// this header holds the route's device code, and matern_regs_f32.cu and
// matern_regs_f64.cu instantiate it (one nvcc process each).
//
// Layout: one warp a point.  F is rounded up to FP, a multiple of 8, with
// identity slots (an invalid slot is identity-extended, so the padded
// matrix is [C 0; 0 I] and the first F entries of x are those of the
// unpadded system, bit for bit).  Lane l owns rows l + 32 r, r < R =
// ceil(FP / 32), and holds row l + 32 r's entries at columns < min(FP,
// 32 (r + 1)) in registers (F = 41: FP = 48, 32 + 48 values a lane).
// Shared memory a warp: two pivot-column buffers (32 R values each), the
// packed lower triangle S (FP (FP + 1) / 2 values, row i at i (i + 1) / 2;
// H5 also keeps dC/dsig2 and dC/drho there in two more such triangles, and
// at a general smoothness dC/dnu in a third), the
// coordinates (FP x d), the validity and nugget vectors (and for H5 the
// solution w and the forward's x).
//
// Per point: the covariance is built into S with the warp's lanes spread
// evenly over the packed pairs (pair q -> row by a float square root),
// each lane loads its rows into registers, and the right-looking Cholesky
// runs in registers: at pivot k the owner of row k's diagonal is shuffled
// to every lane, each lane scales its L[i][k] and writes it once into a
// pivot-column buffer (two buffers alternate, so one __syncwarp a pivot),
// then reads the column back by 16-byte broadcasts and updates its own rows
// in registers.  No read-modify-write of the matrix in shared memory.  The
// diagonal slot keeps 1 / L[k][k].  The forward substitution needs only
// L[i][k] of a lane's own rows and one shuffle a step; for the backward
// substitution L is written once to S (row-major packed: lanes of one
// column hit 32 distinct banks, since i (i + 1) / 2 mod 32 is a permutation
// of 0..31) and read as L[k][i].  A non-positive pivot is not clamped:
// NaN or Inf reaches that point's row only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "matern_common.cuh"

namespace gpv {

constexpr unsigned FULL = 0xffffffffu;
// two warps a block (a fine grain for the register-bound occupancy), fewer
// if their shared memory would not fit a block
constexpr int WARPS = 2;

__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }

// row i of packed index q (row i at [tri(i), tri(i + 1)))
__device__ __forceinline__ int tri_row(int q) {
  const float t = 8.0f * (float)q + 1.0f;
  int i = (int)((t * rsqrtf(t) - 1.0f) * 0.5f);
  if (tri(i + 1) <= q) ++i;
  if (tri(i) > q) --i;
  return i;
}

template <int FP>
struct Shape {
  static constexpr int R = (FP + 31) / 32;  // row slots a lane
  // row lane + 32 r is at most 32 r + 31: its columns stop there
  static __host__ __device__ constexpr int width(int r) {
    return 32 * (r + 1) < FP ? 32 * (r + 1) : FP;
  }
};

// values a warp in shared memory (a multiple of 4, so each warp's region
// starts 16-byte aligned); the general Matern's backward keeps a fourth
// triangle, dC/dnu
__host__ __device__ constexpr int warp_words(int FP, int d, bool bwd,
                                             bool gen = false) {
  return (2 * 32 * ((FP + 31) / 32) +
          tri(FP) * (bwd ? (gen ? 4 : 3) : 1) + FP * d + 2 * FP +
          (bwd ? 2 * FP : 0) + 3) / 4 * 4;
}

// 1 / sqrt(x) of a pivot: NaN below 0, Inf at 0 (no clamp)
__device__ __forceinline__ float inv_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double inv_sqrt(double x) { return 1.0 / sqrt(x); }

// sqrt of a distance^2 > 0: in float32 by the approximate reciprocal root
__device__ __forceinline__ float sqrt_pos(float x) { return x * rsqrtf(x); }
__device__ __forceinline__ double sqrt_pos(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T sq_dist(const T* pts, int i, int j, int d) {
  if (d == 2) {
    const T a = pts[2 * i] - pts[2 * j], b = pts[2 * i + 1] - pts[2 * j + 1];
    return a * a + b * b;
  }
  T d2 = T(0);
  for (int c = 0; c < d; ++c) {
    const T t = pts[i * d + c] - pts[j * d + c];
    d2 += t * t;
  }
  return d2;
}

// 16-byte broadcast loads of the pivot column
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};
template <>
struct Vec<double> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void load(const double* p,
                                              double (&v)[2]) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
};

// the point's coordinates, validity (1/0) and diagonal nugget adds;
// slots >= F are invalid (identity)
template <typename T, int FP>
__device__ __forceinline__ void gather(const T* __restrict__ locs, int d,
                                       const int* __restrict__ NN,
                                       const uint8_t* __restrict__ valid,
                                       const uint8_t* __restrict__ resp,
                                       const T* __restrict__ nug_point,
                                       long p, int F, T* pts, T* vf, T* dg,
                                       int lane) {
  for (int i = lane; i < FP; i += 32) {
    bool v = false;
    T g = T(0);
    if (i < F) {
      const int q = NN[p * F + i];
      v = valid[p * F + i] != 0;
      for (int c = 0; c < d; ++c) pts[i * d + c] = locs[(long)q * d + c];
      if (v && resp[p * F + i] != 0) g = nug_point[q];
    }
    vf[i] = v ? T(1) : T(0);
    dg[i] = g;
  }
}

// S = the packed lower triangle of C, pairs spread evenly over the lanes;
// with GRAD also dC/dsig2 = g(s) and dC/drho = sig2 g'(s) (-s / rho) over
// the valid pairs (0 elsewhere) into Gs and Gr, laid out as S, and for the
// general Matern dC/dnu = sig2 dg/dnu into Gn.  H1 at a closed form (not
// GRAD) takes float32's approximate exp and square root (Closed<T, true>);
// H5 and the general Matern the exact ones: H5's dC entries are summed
// over every pair of every point, and there the approximations' error
// showed against the float32 rule on the card (n=1e6, F=11)
template <typename T, int FP, bool GRAD, typename Cov>
__device__ __forceinline__ void build_packed(T* S, T* Gs, T* Gr, T* Gn,
                                             const T* pts, const T* vf,
                                             const T* dg, int d, T sig2,
                                             T inv_rho, const Cov& cov,
                                             int lane) {
  constexpr bool EXACT = GRAD || Cov::kGeneral;
  for (int q = lane; q < tri(FP); q += 32) {
    const int i = tri_row(q), j = q - tri(i);
    T val, gs = T(0), gr = T(0), gn = T(0);
    if (vf[i] != T(0) && vf[j] != T(0)) {
      const T d2 = sq_dist(pts, i, j, d);
      gs = T(1);
      if (d2 > T(0)) {
        const T s = (EXACT ? sqrt(d2) : sqrt_pos(d2)) * inv_rho;
        if (GRAD) {
          T dgds, dgdnu;
          gs = cov.grad(s, &dgds, &dgdnu);
          gr = sig2 * dgds * (-s * inv_rho);
          if (Cov::kGeneral) gn = sig2 * dgdnu;
        } else {
          gs = cov.value(s);
        }
      }
      val = sig2 * gs;
      if (i == j) val += dg[j];
    } else {
      val = (i == j) ? T(1) : T(0);
    }
    S[q] = val;
    if (GRAD) {
      Gs[q] = gs;
      Gr[q] = gr;
      if (Cov::kGeneral) Gn[q] = gn;
    }
  }
}

template <typename T, int FP>
__device__ __forceinline__ void load_rows(const T* S,
                                          T (&a)[Shape<FP>::R][FP],
                                          int lane) {
#pragma unroll
  for (int r = 0; r < Shape<FP>::R; ++r) {
    const int i = lane + 32 * r;
    const T* row = S + tri(i);
#pragma unroll
    for (int j = 0; j < Shape<FP>::width(r); ++j) {
      a[r][j] = T(0);
      if (j <= i && i < FP) a[r][j] = row[j];
    }
  }
}

// right-looking Cholesky in registers: a[r][k] <- L[i][k] below the
// diagonal, 1 / L[k][k] on it
template <typename T, int FP>
__device__ __forceinline__ void reg_chol(T (&a)[Shape<FP>::R][FP], T* col,
                                         int lane) {
  constexpr int R = Shape<FP>::R, V = Vec<T>::N;
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    const int rk = k / 32;
    const T inv = inv_sqrt(__shfl_sync(FULL, a[rk][k], k % 32));
    T* c = col + (k & 1) * 32 * R;
    T l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      l[r] = T(0);
      if (32 * r + 31 > k) {           // the slot holds rows below k
        l[r] = (i > k) ? a[r][k] * inv : T(0);
        c[i] = l[r];
        if (i > k) a[r][k] = l[r];
      }
      if (r == rk && i == k) a[r][k] = inv;
    }
    __syncwarp();
#pragma unroll
    for (int j0 = (k + 1) / V * V; j0 < FP; j0 += V) {
      T v[V];
      Vec<T>::load(c + j0, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = j0 + e;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (j > k && j < Shape<FP>::width(r) && 32 * r + 31 > k)
            a[r][j] -= l[r] * v[e];
      }
    }
  }
}

// y <- L^{-1} y
template <typename T, int FP>
__device__ __forceinline__ void reg_forward(const T (&a)[Shape<FP>::R][FP],
                                            T (&y)[Shape<FP>::R], int lane) {
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    const int rk = k / 32;
    const T yk = __shfl_sync(FULL, y[rk] * a[rk][k], k % 32);
#pragma unroll
    for (int r = 0; r < Shape<FP>::R; ++r) {
      if (32 * r + 31 < k) continue;
      const int i = lane + 32 * r;
      if (i == k)
        y[r] = yk;
      else if (i > k)
        y[r] -= a[r][k] * yk;
    }
  }
}

// L into S, row-major packed, for the backward substitution
template <typename T, int FP>
__device__ __forceinline__ void store_rows(T* S,
                                           const T (&a)[Shape<FP>::R][FP],
                                           int lane) {
#pragma unroll
  for (int r = 0; r < Shape<FP>::R; ++r) {
    const int i = lane + 32 * r;
    T* row = S + tri(i);
#pragma unroll
    for (int j = 0; j < Shape<FP>::width(r); ++j)
      if (j <= i && i < FP) row[j] = a[r][j];
  }
}

// y <- L^{-T} y, reading L[k][i] from S
template <typename T, int FP>
__device__ __forceinline__ void reg_backward(const T (&a)[Shape<FP>::R][FP],
                                             const T* S,
                                             T (&y)[Shape<FP>::R], int lane) {
#pragma unroll
  for (int k = FP - 1; k >= 0; --k) {
    const int rk = k / 32;
    const T xk = __shfl_sync(FULL, y[rk] * a[rk][k], k % 32);
    const T* row = S + tri(k);
#pragma unroll
    for (int r = 0; r < Shape<FP>::R; ++r) {
      if (32 * r > k) continue;
      const int i = lane + 32 * r;
      if (i == k)
        y[r] = xk;
      else if (i < k)
        y[r] -= row[i] * xk;
    }
  }
}

// C's factor in registers and y <- C^{-1} y; S holds L afterwards
template <typename T, int FP>
__device__ __forceinline__ void factor_solve(T* S, T* col,
                                             T (&y)[Shape<FP>::R], int lane) {
  T a[Shape<FP>::R][FP];
  load_rows<T, FP>(S, a, lane);
  reg_chol<T, FP>(a, col, lane);     // its __syncwarp()s end every S read
  reg_forward<T, FP>(a, y, lane);
  store_rows<T, FP>(S, a, lane);
  __syncwarp();
  reg_backward<T, FP>(a, S, y, lane);
}

template <typename T, int FP, typename Cov>
__device__ __forceinline__ void h1_body(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho,
    const Cov& cov, T* __restrict__ x) {
  constexpr int R = Shape<FP>::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* col = reinterpret_cast<T*>(smem_raw) +
           (size_t)warp * warp_words(FP, d, false);
  T* S = col + 64 * R;
  T* pts = S + tri(FP);
  T* vf = pts + FP * d;
  T* dg = vf + FP;
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;                      // whole warp leaves together

  gather<T, FP>(locs, d, NN, valid, resp, nug_point, p, F, pts, vf, dg, lane);
  __syncwarp();
  build_packed<T, FP, false>(S, nullptr, nullptr, nullptr, pts, vf, dg, d,
                             sig2, T(1) / rho, cov, lane);
  __syncwarp();
  T y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] = (lane + 32 * r == 0) ? T(1) : T(0);
  factor_solve<T, FP>(S, col, y, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < F) x[p * F + i] = y[r];
  }
}

// NPAR = 2 partial sums a point (sig2, rho) at the closed forms, 3 (with
// nu) for the general Matern
template <typename T, int FP, typename Cov>
__device__ __forceinline__ void h5_body(
    const T* __restrict__ locs, int d, const int* __restrict__ NN,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ resp,
    const T* __restrict__ nug_point, int n, int F, T sig2, T rho,
    const Cov& cov, const T* __restrict__ x, const T* __restrict__ xbar,
    double* __restrict__ dpar, T* __restrict__ dslot) {
  constexpr int R = Shape<FP>::R;
  constexpr bool GEN = Cov::kGeneral;
  constexpr int NPAR = GEN ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* col = reinterpret_cast<T*>(smem_raw) +
           (size_t)warp * warp_words(FP, d, true, GEN);
  T* S = col + 64 * R;
  T* Gs = S + tri(FP);                     // dC/dsig2
  T* Gr = Gs + tri(FP);                    // dC/drho
  T* Gn = Gr + tri(FP);                    // dC/dnu (general only)
  T* pts = Gn + (GEN ? tri(FP) : 0);
  T* vf = pts + FP * d;
  T* dg = vf + FP;
  T* ws = dg + FP;                         // w = C^{-1} xbar
  T* xs = ws + FP;                         // the forward's x
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;

  gather<T, FP>(locs, d, NN, valid, resp, nug_point, p, F, pts, vf, dg, lane);
  for (int i = lane; i < FP; i += 32) xs[i] = (i < F) ? x[p * F + i] : T(0);
  __syncwarp();
  build_packed<T, FP, true>(S, Gs, Gr, Gn, pts, vf, dg, d, sig2, T(1) / rho,
                            cov, lane);
  __syncwarp();
  T y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    y[r] = (i < F) ? xbar[p * F + i] : T(0);
  }
  factor_solve<T, FP>(S, col, y, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < FP) ws[i] = y[r];
  }
  __syncwarp();

  // K2's packed cotangent gbar[i >= j] = -(w_i x_j + w_j x_i) (-w_i x_i on
  // the diagonal), contracted pair by pair with dC/dsig2, dC/drho (and
  // dC/dnu) from the build, over the valid pairs, spread evenly over the
  // lanes; the partial sums are kept in double, so a float32 run loses no
  // digits in them
  double a_sig2 = 0.0, a_rho = 0.0, a_nu = 0.0;
  for (int q = lane; q < tri(F); q += 32) {
    const int i = tri_row(q), j = q - tri(i);
    if (vf[i] == T(0) || vf[j] == T(0)) continue;  // identity-extended
    const T g = (i == j) ? -ws[i] * xs[i] : -(ws[i] * xs[j] + ws[j] * xs[i]);
    a_sig2 += (double)(g * Gs[q]);
    a_rho += (double)(g * Gr[q]);
    if (GEN) a_nu += (double)(g * Gn[q]);
  }
  for (int j = lane; j < F; j += 32)
    dslot[p * F + j] = (vf[j] != T(0) && resp[p * F + j] != 0)
                           ? -ws[j] * xs[j] : T(0);
  a_sig2 = warp_sum(a_sig2);
  a_rho = warp_sum(a_rho);
  if (GEN) a_nu = warp_sum(a_nu);
  if (lane == 0) {
    dpar[p * NPAR] = a_sig2;
    dpar[p * NPAR + 1] = a_rho;
    if (GEN) dpar[p * NPAR + 2] = a_nu;
  }
}

// ------------------------------------------------------- H8 and K2
// H8 solve_e0 and solve_e0_bwd (K2 one to one) on a given packed covariance
// (esqe, user covariances, a full matrix, the general Matern above H1's
// bound): the build step loads the point's packed row (the upper triangle
// row by row, row j at off_row(F, j)) from device memory into S, slots >= F
// identity; the factor and the solves are H1's.  solve_e0_bwd then writes
// K2's packed cotangent -(w_i x_j + w_j x_i) (-w_i x_i on the diagonal).
// Shared memory a warp: the two pivot-column buffers and S, and for K2 w and
// x.

__host__ __device__ constexpr int off_row(int F, int j) {
  return j * F - j * (j - 1) / 2;
}

__host__ __device__ constexpr int packed_words(int FP, bool bwd) {
  return (2 * 32 * ((FP + 31) / 32) + tri(FP) + (bwd ? 2 * FP : 0) + 3) / 4 *
         4;
}

template <typename T, int FP>
__device__ __forceinline__ void load_packed(const T* __restrict__ cp, int F,
                                            T* S, int lane) {
  for (int q = lane; q < tri(FP); q += 32) {
    const int i = tri_row(q), j = q - tri(i);
    S[q] = i < F ? cp[off_row(F, j) + i - j] : (i == j ? T(1) : T(0));
  }
}

template <typename T, int FP>
__device__ __forceinline__ void h8_body(const T* __restrict__ Cp, int n,
                                        int F, T* __restrict__ x) {
  constexpr int R = Shape<FP>::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* col = reinterpret_cast<T*>(smem_raw) +
           (size_t)warp * packed_words(FP, false);
  T* S = col + 64 * R;
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;                      // whole warp leaves together

  load_packed<T, FP>(Cp + p * ((long)F * (F + 1) / 2), F, S, lane);
  __syncwarp();
  T y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] = (lane + 32 * r == 0) ? T(1) : T(0);
  factor_solve<T, FP>(S, col, y, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < F) x[p * F + i] = y[r];
  }
}

template <typename T, int FP>
__device__ __forceinline__ void k2_body(const T* __restrict__ Cp, int n,
                                        int F, const T* __restrict__ x,
                                        const T* __restrict__ xbar,
                                        T* __restrict__ g) {
  constexpr int R = Shape<FP>::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* col = reinterpret_cast<T*>(smem_raw) +
           (size_t)warp * packed_words(FP, true);
  T* S = col + 64 * R;
  T* ws = S + tri(FP);                     // w = C^{-1} xbar
  T* xs = ws + FP;                         // the forward's x
  const long p = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n) return;
  const long P = (long)F * (F + 1) / 2;

  for (int i = lane; i < FP; i += 32) xs[i] = (i < F) ? x[p * F + i] : T(0);
  load_packed<T, FP>(Cp + p * P, F, S, lane);
  __syncwarp();
  T y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    y[r] = (i < F) ? xbar[p * F + i] : T(0);
  }
  factor_solve<T, FP>(S, col, y, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < FP) ws[i] = y[r];
  }
  __syncwarp();
  T* gp = g + p * P;
  for (int q = lane; q < tri(F); q += 32) {  // (i >= j) is upper (j, i)
    const int i = tri_row(q), j = q - tri(i);
    gp[off_row(F, j) + i - j] =
        (i == j) ? -ws[i] * xs[i] : -(ws[i] * xs[j] + ws[j] * xs[i]);
  }
}

// Registers decide the occupancy.  Where a lane's rows take many of them
// (FP >= 40) the compiler is held to 128 a thread, 16 warps an SM, which
// ran faster on the card than its own choice (up to ~170 a thread, 12
// warps) in spite of a few spilled values, except for H5 above FP = 48;
// elsewhere it is left alone (a bound there made it take more registers,
// not fewer).  The general Matern's kernels follow the same rule.
__host__ __device__ constexpr bool capped(bool bwd, int FP) {
  return FP >= 40 && (!bwd || FP <= 48);
}
constexpr int CAPPED_BLOCKS = 65536 / (128 * 32 * WARPS);

#define GPV_H1_PARAMS                                                       \
  const T *__restrict__ locs, int d, const int *__restrict__ NN,            \
      const uint8_t *__restrict__ valid, const uint8_t *__restrict__ resp,  \
      const T *__restrict__ nug_point, int n, int F, T sig2, T rho
#define GPV_H1_ARGS locs, d, NN, valid, resp, nug_point, n, F, sig2, rho
#define GPV_H5_PARAMS                                                 \
  const T *__restrict__ x, const T *__restrict__ xbar,                \
      double *__restrict__ dpar, T *__restrict__ dslot
#define GPV_H5_ARGS x, xbar, dpar, dslot

// the closed forms (nu_idx 0, 1, 2) and the general Matern (gp), each
// with and without the register cap
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS)
    matern_solve_e0_regs_kernel(GPV_H1_PARAMS, int nu_idx,
                                T* __restrict__ x) {
  h1_body<T, FP>(GPV_H1_ARGS, Closed<T, true>{nu_idx}, x);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS, CAPPED_BLOCKS)
    matern_solve_e0_regs_capped_kernel(GPV_H1_PARAMS, int nu_idx,
                                       T* __restrict__ x) {
  h1_body<T, FP>(GPV_H1_ARGS, Closed<T, true>{nu_idx}, x);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS)
    matern_solve_e0_bwd_regs_kernel(GPV_H1_PARAMS, int nu_idx,
                                    GPV_H5_PARAMS) {
  h5_body<T, FP>(GPV_H1_ARGS, Closed<T>{nu_idx}, GPV_H5_ARGS);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS, CAPPED_BLOCKS)
    matern_solve_e0_bwd_regs_capped_kernel(GPV_H1_PARAMS, int nu_idx,
                                           GPV_H5_PARAMS) {
  h5_body<T, FP>(GPV_H1_ARGS, Closed<T>{nu_idx}, GPV_H5_ARGS);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS)
    matern_solve_e0_gen_regs_kernel(GPV_H1_PARAMS, const GenParams<T> gp,
                                    T* __restrict__ x) {
  h1_body<T, FP>(GPV_H1_ARGS, General<T>{gp}, x);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS, CAPPED_BLOCKS)
    matern_solve_e0_gen_regs_capped_kernel(GPV_H1_PARAMS,
                                           const GenParams<T> gp,
                                           T* __restrict__ x) {
  h1_body<T, FP>(GPV_H1_ARGS, General<T>{gp}, x);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS)
    matern_solve_e0_bwd_gen_regs_kernel(GPV_H1_PARAMS, const GenParams<T> gp,
                                        GPV_H5_PARAMS) {
  h5_body<T, FP>(GPV_H1_ARGS, General<T>{gp}, GPV_H5_ARGS);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS, CAPPED_BLOCKS)
    matern_solve_e0_bwd_gen_regs_capped_kernel(GPV_H1_PARAMS,
                                               const GenParams<T> gp,
                                               GPV_H5_PARAMS) {
  h5_body<T, FP>(GPV_H1_ARGS, General<T>{gp}, GPV_H5_ARGS);
}

// H8 and K2 take H1's register rule
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS)
    solve_e0_regs_kernel(const T* __restrict__ Cp, int n, int F,
                         T* __restrict__ x) {
  h8_body<T, FP>(Cp, n, F, x);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS, CAPPED_BLOCKS)
    solve_e0_regs_capped_kernel(const T* __restrict__ Cp, int n, int F,
                                T* __restrict__ x) {
  h8_body<T, FP>(Cp, n, F, x);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS)
    solve_e0_bwd_regs_kernel(const T* __restrict__ Cp, int n, int F,
                             const T* __restrict__ x,
                             const T* __restrict__ xbar, T* __restrict__ g) {
  k2_body<T, FP>(Cp, n, F, x, xbar, g);
}
template <typename T, int FP>
__global__ void __launch_bounds__(32 * WARPS, CAPPED_BLOCKS)
    solve_e0_bwd_regs_capped_kernel(const T* __restrict__ Cp, int n, int F,
                                    const T* __restrict__ x,
                                    const T* __restrict__ xbar,
                                    T* __restrict__ g) {
  k2_body<T, FP>(Cp, n, F, x, xbar, g);
}

constexpr size_t SMEM_MAX = 232448;

// the block's warps and its shared memory (above 48 KB the kernel is allowed
// the larger dynamic size), then the launch
template <typename K, typename... A>
int launch(K kernel, size_t per_warp, int n, cudaStream_t stream, A... args) {
  int warps = (int)(SMEM_MAX / per_warp < WARPS ? SMEM_MAX / per_warp : WARPS);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(n + warps - 1) / warps, 32 * warps, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// gen: null at a closed form (nu_idx), else the general Matern's
// host constants (kernels/matern_solve.py `general_params`)
template <typename T, int FP>
int launch_fwd(const T* locs, int d, const int* NN, const uint8_t* valid,
               const uint8_t* resp, const T* nug_point, int n, int F,
               double sig2, double rho, int nu_idx, const double* gen, T* x,
               cudaStream_t stream) {
  const size_t per_warp = warp_words(FP, d, false) * sizeof(T);
  const T s2 = (T)sig2, rh = (T)rho;
  if (gen) {
    const GenParams<T> gp = gen_params<T>(gen);
    if constexpr (capped(false, FP))
      return launch(matern_solve_e0_gen_regs_capped_kernel<T, FP>, per_warp,
                    n, stream, locs, d, NN, valid, resp, nug_point, n, F, s2,
                    rh, gp, x);
    else
      return launch(matern_solve_e0_gen_regs_kernel<T, FP>, per_warp, n,
                    stream, locs, d, NN, valid, resp, nug_point, n, F, s2, rh,
                    gp, x);
  }
  if constexpr (capped(false, FP))
    return launch(matern_solve_e0_regs_capped_kernel<T, FP>, per_warp, n,
                  stream, locs, d, NN, valid, resp, nug_point, n, F, s2, rh,
                  nu_idx, x);
  else
    return launch(matern_solve_e0_regs_kernel<T, FP>, per_warp, n, stream,
                  locs, d, NN, valid, resp, nug_point, n, F, s2, rh, nu_idx,
                  x);
}

template <typename T, int FP>
int launch_bwd(const T* locs, int d, const int* NN, const uint8_t* valid,
               const uint8_t* resp, const T* nug_point, int n, int F,
               double sig2, double rho, int nu_idx, const double* gen,
               const T* x, const T* xbar, double* dpar, T* dslot,
               cudaStream_t stream) {
  const T s2 = (T)sig2, rh = (T)rho;
  if (gen) {
    const size_t per_warp = warp_words(FP, d, true, true) * sizeof(T);
    const GenParams<T> gp = gen_params<T>(gen);
    if constexpr (capped(true, FP))
      return launch(matern_solve_e0_bwd_gen_regs_capped_kernel<T, FP>,
                    per_warp, n, stream, locs, d, NN, valid, resp, nug_point,
                    n, F, s2, rh, gp, x, xbar, dpar, dslot);
    else
      return launch(matern_solve_e0_bwd_gen_regs_kernel<T, FP>, per_warp, n,
                    stream, locs, d, NN, valid, resp, nug_point, n, F, s2, rh,
                    gp, x, xbar, dpar, dslot);
  }
  const size_t per_warp = warp_words(FP, d, true) * sizeof(T);
  if constexpr (capped(true, FP))
    return launch(matern_solve_e0_bwd_regs_capped_kernel<T, FP>, per_warp, n,
                  stream, locs, d, NN, valid, resp, nug_point, n, F, s2, rh,
                  nu_idx, x, xbar, dpar, dslot);
  else
    return launch(matern_solve_e0_bwd_regs_kernel<T, FP>, per_warp, n,
                  stream, locs, d, NN, valid, resp, nug_point, n, F, s2, rh,
                  nu_idx, x, xbar, dpar, dslot);
}

template <typename T, int FP>
int launch_h8(const T* Cp, int n, int F, T* x, cudaStream_t stream) {
  const size_t per_warp = packed_words(FP, false) * sizeof(T);
  if constexpr (capped(false, FP))
    return launch(solve_e0_regs_capped_kernel<T, FP>, per_warp, n, stream,
                  Cp, n, F, x);
  else
    return launch(solve_e0_regs_kernel<T, FP>, per_warp, n, stream, Cp, n,
                  F, x);
}

template <typename T, int FP>
int launch_k2(const T* Cp, int n, int F, const T* x, const T* xbar, T* g,
              cudaStream_t stream) {
  const size_t per_warp = packed_words(FP, true) * sizeof(T);
  if constexpr (capped(false, FP))
    return launch(solve_e0_bwd_regs_capped_kernel<T, FP>, per_warp, n,
                  stream, Cp, n, F, x, xbar, g);
  else
    return launch(solve_e0_bwd_regs_kernel<T, FP>, per_warp, n, stream, Cp,
                  n, F, x, xbar, g);
}

// the instantiated sizes FP...: a launch at F takes the first FP >= F
template <typename T, int FP, int... Rest>
struct Sizes {
  template <typename... A>
  static int fwd(int F, A... args) {
    if (F <= FP) return launch_fwd<T, FP>(args...);
    if constexpr (sizeof...(Rest) > 0)
      return Sizes<T, Rest...>::fwd(F, args...);
    return (int)cudaErrorInvalidValue;
  }
  template <typename... A>
  static int bwd(int F, A... args) {
    if (F <= FP) return launch_bwd<T, FP>(args...);
    if constexpr (sizeof...(Rest) > 0)
      return Sizes<T, Rest...>::bwd(F, args...);
    return (int)cudaErrorInvalidValue;
  }
  template <typename... A>
  static int h8(int F, A... args) {
    if (F <= FP) return launch_h8<T, FP>(args...);
    if constexpr (sizeof...(Rest) > 0)
      return Sizes<T, Rest...>::h8(F, args...);
    return (int)cudaErrorInvalidValue;
  }
  template <typename... A>
  static int k2(int F, A... args) {
    if (F <= FP) return launch_k2<T, FP>(args...);
    if constexpr (sizeof...(Rest) > 0)
      return Sizes<T, Rest...>::k2(F, args...);
    return (int)cudaErrorInvalidValue;
  }
};

}  // namespace gpv
