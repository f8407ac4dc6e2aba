// Multifrontal level kernels: H2 leaf_assemble, H3 extend_add and
// H4 front_factor.  All fronts are augmented: front row/column F1-1 carries
// the right-hand side, so the factor's border solve yields y = L_pp^{-1} b
// in row F1-1 and the Schur block carries the RHS update to the parent
// (the formulation of gpvecchia_tpu/linalg/pallas_level.py:24-28).
//
// H2 leaf_assemble replaces the assembly half of the TPU kernel
// linalg/pallas_level.py `_leaf_kernel` (pallas_call at :594, entry
// `fused_leaf`): front = sum_e u_e u_e^T over the leaf's elements, with the
// element's RHS weight at position F1-1, plus D on the pivot diagonal and
// rhs_vert in row and column F1-1.  Bound on an H100 by read-modify-writes:
// each element adds (K+1)^2 products to scattered front entries (1.8e9 at
// n=1e6, m=40).  Design: one block per front walks the elements in order;
// inside one element every (k, l) pair hits a distinct entry, so threads
// over the pairs update without atomics and a barrier separates elements.
// The sum order is fixed, so the result does not change from run to run.
// Only the lower triangle is written (the factor reads nothing else).
//
// H3 extend_add replaces the assembly halves of `_level_kernel` (:344,
// `fused_level`) and `_afront_kernel` (:756, `assemble_fronts`), and the
// forward of linalg/pallas_eadd.py `_fwd_kernel` (:98, `eadd_fronts`):
// front[i][j] = sum_s upd_s[ext_s[i]][ext_s[j]] + D + the RHS row/column,
// reading each symmetric child block through its lower triangle and
// writing the front's lower triangle.  A pure gather, bound by device-memory
// bandwidth; one thread per output entry, coalesced writes, no TPU panel
// plans.
//
// H4 front_factor replaces linalg/pallas_frontal.py `_factor_kernel`
// (:180, `factor_fronts`), the factor and Schur halves of the leaf and level
// kernels (`_factor_core`, `_finish`) and the Schur einsum of
// linalg/multifrontal.py:628-629.  A partial Cholesky over the first P
// columns, in place: L_pp in the lower [:P, :P], L_bp_aug = A_bp L_pp^{-T}
// in [P:, :P] (its last row is y) and upd_aug = A_bb - L_bp L_bp^T in the
// lower triangle of [P:, P:].  Bound on the chip by the trailing update's
// FMA loop (f32 at n=1e6 shapes: ~5 TFLOP/s at the leaf and ~8 TFLOP/s at
// fronts of 5270, of the 67 TFLOP/s SIMT peak; H100 80GB HBM3, 700 W), and
// at the root (N = 1, F ~ 3500) by the serial chain of panels.  Design: a
// right-looking sweep of 32-wide panels, each panel launched once over ALL
// fronts of the level: diagonal tile (one warp per front), panel TRSM (one
// thread per row, grid over fronts x row blocks) and trailing update (64 x 64
// shared-memory tiles, 256 threads of 4 x 4 outputs, grid over fronts x
// lower-triangle tiles; 64 threads of 8 x 8, and 32 x 32 tiles, measured
// slower on an H100).  The same code path fills the card at the leaf
// (N = 8192) and at the root.  All three kernels read and write lower
// triangles only; the upper triangle of a front is never initialized.
// Pivots are not clamped: a non-SPD front gives NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NB = 32;       // panel width
constexpr int TS = 64;       // trailing-update tile (TS x TS outputs)
constexpr int TM = 4;        // per-thread outputs (TM x TM)
constexpr int TT = TS / TM;  // threads per tile side
constexpr int UPD_THREADS = TT * TT;
constexpr int TRSM_ROWS = 128;
static_assert(UPD_THREADS % 32 == 0, "whole warps per update block");

template <typename T>
__global__ void leaf_assemble_kernel(const T* __restrict__ u,
                                     const int* __restrict__ epos,
                                     const T* __restrict__ rhs_elem,
                                     const T* __restrict__ dv,
                                     const T* __restrict__ rv, int EL, int K,
                                     int F1, T* __restrict__ front) {
  const long n = blockIdx.x;
  T* A = front + n * (long)F1 * F1;
  for (int i = 0; i < F1; ++i)
    for (int j = threadIdx.x; j <= i; j += blockDim.x) A[(long)i * F1 + j] = T(0);
  __syncthreads();
  const int K1 = K + 1;
  const int pairs = K1 * K1;
  const T* un = u + n * EL * K;
  const int* pn = epos + n * EL * K;
  const T* rn = rhs_elem + n * EL;
  for (int e = 0; e < EL; ++e) {
    for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
      const int k = t / K1;
      const int l = t - k * K1;
      int pk, pl;
      T uk, ul;
      if (k < K) { pk = pn[e * K + k]; uk = un[e * K + k]; }
      else       { pk = F1 - 1;        uk = rn[e]; }
      if (l < K) { pl = pn[e * K + l]; ul = un[e * K + l]; }
      else       { pl = F1 - 1;        ul = rn[e]; }
      if (pl >= 0 && pk >= pl) A[(long)pk * F1 + pl] += uk * ul;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < F1; i += blockDim.x)
    A[(long)i * F1 + i] += dv[n * F1 + i];
  __syncthreads();
  for (int i = threadIdx.x; i < F1; i += blockDim.x)
    A[(long)(F1 - 1) * F1 + i] += rv[n * F1 + i];
}

template <typename T>
__global__ void extend_add_kernel(const T* __restrict__ upd, long s_node,
                                  long s_child, long s_row,
                                  const int* __restrict__ ext,
                                  const T* __restrict__ dv,
                                  const T* __restrict__ rv, int F1,
                                  T* __restrict__ front) {
  const long n = blockIdx.y;
  const long FF = (long)F1 * F1;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= FF) return;
  const int i = (int)(t / F1);
  const int j = (int)(t - (long)i * F1);
  if (j > i) return;                       // lower triangle only
  const int* en = ext + n * 2 * F1;
  T acc = T(0);
  for (int s = 0; s < 2; ++s) {
    const int a = en[s * F1 + i];
    const int b = en[s * F1 + j];
    if (a >= 0 && b >= 0)                  // children's lower triangles
      acc += upd[n * s_node + s * s_child + (long)(a > b ? a : b) * s_row +
                 (a > b ? b : a)];
  }
  if (i == j) acc += dv[n * F1 + i];
  if (i == F1 - 1) acc += rv[n * F1 + j];
  front[n * FF + t] = acc;
}

// diagonal tile of panel k0 (width kb <= NB): one warp per front
template <typename T>
__global__ void panel_diag_kernel(T* __restrict__ front, int F1, int k0,
                                  int kb) {
  __shared__ T S[NB][NB + 1];
  T* A = front + (long)blockIdx.x * F1 * F1;
  const int lane = threadIdx.x;
  if (lane < kb)
    for (int j = 0; j <= lane; ++j)
      S[lane][j] = A[(long)(k0 + lane) * F1 + k0 + j];
  __syncwarp();
  for (int k = 0; k < kb; ++k) {
    const T inv = T(1) / sqrt(S[k][k]);
    __syncwarp();
    if (lane >= k && lane < kb) S[lane][k] *= inv;
    __syncwarp();
    if (lane > k && lane < kb) {
      const T lik = S[lane][k];
      for (int j = k + 1; j <= lane; ++j) S[lane][j] -= lik * S[j][k];
    }
    __syncwarp();
  }
  if (lane < kb)
    for (int j = 0; j <= lane; ++j)
      A[(long)(k0 + lane) * F1 + k0 + j] = S[lane][j];
}

// panel TRSM: rows r >= k0+kb solve x L11^T = A[r, k0:k0+kb]
template <typename T>
__global__ void panel_trsm_kernel(T* __restrict__ front, int F1, int k0,
                                  int kb) {
  __shared__ T L[NB][NB + 1];
  T* A = front + (long)blockIdx.y * F1 * F1;
  for (int t = threadIdx.x; t < NB * NB; t += blockDim.x) {
    const int i = t / NB, j = t - (t / NB) * NB;
    L[i][j] = (i < kb && j <= i) ? A[(long)(k0 + i) * F1 + k0 + j] : T(0);
  }
  __syncthreads();
  const int r = k0 + kb + blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= F1) return;
  T* row = A + (long)r * F1 + k0;
  T x[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < kb) {
      T s = row[j];
#pragma unroll
      for (int l = 0; l < j; ++l) s -= x[l] * L[j][l];
      x[j] = s / L[j][j];
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < kb) row[j] = x[j];
}

// trailing update of rows/columns >= k0+kb, lower-triangle tiles only.
// A TS x TS tile per block, TM x TM outputs per thread; the two L21 panels
// are staged in shared memory with rows padded to TS+1, so both the
// coalesced staging stores and the compute loads are free of bank conflicts,
// and each thread does TM*TM FMAs per 2*TM shared loads.
template <typename T>
__global__ void panel_update_kernel(T* __restrict__ front, int F1, int k0,
                                    int kb) {
  __shared__ T Li[NB][TS + 1];
  __shared__ T Lj[NB][TS + 1];
  T* A = front + (long)blockIdx.y * F1 * F1;
  const int r0 = k0 + kb;
  // blockIdx.x enumerates the tiles (ti, tj) with tj <= ti, row by row
  int ti = (int)((sqrtf(8.0f * blockIdx.x + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  while (ti * (ti + 1) / 2 > (int)blockIdx.x) --ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = r0 + ti * TS, j0 = r0 + tj * TS;
  // stage: each warp copies whole rows c; lane = column l of the panel
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < TS; c += UPD_THREADS / 32) {
    Li[lane][c] = (lane < kb && i0 + c < F1)
                      ? A[(long)(i0 + c) * F1 + k0 + lane] : T(0);
    Lj[lane][c] = (lane < kb && j0 + c < F1)
                      ? A[(long)(j0 + c) * F1 + k0 + lane] : T(0);
  }
  __syncthreads();
  const int tx = threadIdx.x % TT, ty = threadIdx.x / TT;
  T acc[TM][TM];
#pragma unroll
  for (int p = 0; p < TM; ++p)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[p][q] = T(0);
  for (int l = 0; l < kb; ++l) {
    T a[TM], b[TM];
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      a[q] = Li[l][ty + TT * q];
      b[q] = Lj[l][tx + TT * q];
    }
#pragma unroll
    for (int p = 0; p < TM; ++p)
#pragma unroll
      for (int q = 0; q < TM; ++q) acc[p][q] += a[p] * b[q];
  }
#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int i = i0 + ty + TT * p;
    if (i >= F1) continue;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int j = j0 + tx + TT * q;
      if (j < F1) A[(long)i * F1 + j] -= acc[p][q];
    }
  }
}

template <typename T>
int launch_leaf_assemble(const T* u, const int* epos, const T* rhs_elem,
                         const T* dv, const T* rv, int N, int EL, int K,
                         int F1, T* front, cudaStream_t st) {
  if (N == 0) return 0;
  leaf_assemble_kernel<T><<<N, 256, 0, st>>>(u, epos, rhs_elem, dv, rv, EL, K,
                                             F1, front);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_extend_add(const T* upd, long s_node, long s_child, long s_row,
                      const int* ext, const T* dv, const T* rv, int N, int F1,
                      T* front, cudaStream_t st) {
  if (N == 0) return 0;
  const long FF = (long)F1 * F1;
  dim3 grid((unsigned)((FF + 255) / 256), (unsigned)N);
  extend_add_kernel<T><<<grid, 256, 0, st>>>(upd, s_node, s_child, s_row, ext,
                                             dv, rv, F1, front);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_front_factor(T* front, int N, int F1, int P, cudaStream_t st) {
  if (N == 0) return 0;
  for (int k0 = 0; k0 < P; k0 += NB) {
    const int kb = P - k0 < NB ? P - k0 : NB;
    panel_diag_kernel<T><<<N, 32, 0, st>>>(front, F1, k0, kb);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int R = F1 - k0 - kb;
    if (R <= 0) continue;
    dim3 gt((R + TRSM_ROWS - 1) / TRSM_ROWS, N);
    panel_trsm_kernel<T><<<gt, TRSM_ROWS, 0, st>>>(front, F1, k0, kb);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int tiles = (R + TS - 1) / TS;
    dim3 gu(tiles * (tiles + 1) / 2, N);
    panel_update_kernel<T><<<gu, UPD_THREADS, 0, st>>>(front, F1, k0, kb);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

int gpv_leaf_assemble_f32(const float* u, const int* epos,
                          const float* rhs_elem, const float* dv,
                          const float* rv, int N, int EL, int K, int F1,
                          float* front, void* stream) {
  return launch_leaf_assemble<float>(u, epos, rhs_elem, dv, rv, N, EL, K, F1,
                                     front, (cudaStream_t)stream);
}

int gpv_leaf_assemble_f64(const double* u, const int* epos,
                          const double* rhs_elem, const double* dv,
                          const double* rv, int N, int EL, int K, int F1,
                          double* front, void* stream) {
  return launch_leaf_assemble<double>(u, epos, rhs_elem, dv, rv, N, EL, K, F1,
                                      front, (cudaStream_t)stream);
}

int gpv_extend_add_f32(const float* upd, long long s_node, long long s_child,
                       long long s_row, const int* ext, const float* dv,
                       const float* rv, int N, int F1, float* front,
                       void* stream) {
  return launch_extend_add<float>(upd, s_node, s_child, s_row, ext, dv, rv, N,
                                  F1, front, (cudaStream_t)stream);
}

int gpv_extend_add_f64(const double* upd, long long s_node,
                       long long s_child, long long s_row, const int* ext,
                       const double* dv, const double* rv, int N, int F1,
                       double* front, void* stream) {
  return launch_extend_add<double>(upd, s_node, s_child, s_row, ext, dv, rv, N,
                                   F1, front, (cudaStream_t)stream);
}

int gpv_front_factor_f32(float* front, int N, int F1, int P, void* stream) {
  return launch_front_factor<float>(front, N, F1, P, (cudaStream_t)stream);
}

int gpv_front_factor_f64(double* front, int N, int F1, int P, void* stream) {
  return launch_front_factor<double>(front, N, F1, P, (cudaStream_t)stream);
}

}  // extern "C"
