// Multifrontal level kernels: H2 leaf_assemble, H3 extend_add and
// H4 front_factor, and their backward: H9 front_factor_bwd, H6
// extend_add_bwd and H7 leaf_assemble_bwd.  All fronts are augmented: front row/column F1-1 carries
// the right-hand side, so the factor's border solve yields y = L_pp^{-1} b
// in row F1-1 and the Schur block carries the RHS update to the parent
// (the formulation of gpvecchia_tpu/linalg/pallas_level.py:24-28).
//
// H2 leaf_assemble replaces the assembly half of the TPU kernel
// linalg/pallas_level.py `_leaf_kernel` (pallas_call at :594, entry
// `fused_leaf`): front = sum_e u_e u_e^T over the leaf's elements, with the
// element's RHS weight at position F1-1, plus D on the pivot diagonal and
// rhs_vert in row and column F1-1.  Each element adds the lower triangle of
// its (K+1)^2 products to scattered front entries; a front's lower triangle (330^2 / 2 values at the leaf, 218 KB in
// float32) is larger than an SM's L1, so read-modify-writes of device memory
// would reach L2 or HBM each.  Design: the triangle is cut into R row bands
// of about equal area (R from F1 and the dtype, each band about
// LA_BAND_BYTES: 4 bands and 3 blocks an SM at the leaf in float32), and one
// block per (front, band) accumulates its band in shared memory.  The
// elements come in chunks of up to 32: a thread loads its slots of the next
// chunk (positions and values, the RHS weight as slot K at position F1-1)
// into registers while the block works on the current one.  A chunk's slots
// that fall in the band are listed row by row: each row gets a 32-bit mask
// of the chunk's elements that touch it (an element touches a row once),
// the rows' counts are summed in order, and a slot's place is its row's
// start plus the number of earlier elements in the row's mask, so each
// row's entries are in element order.  Warp w walks the rows that start in
// the w-th eighth of the list, in two groups of 16 lanes with a contiguous
// run of rows each; for an entry (element e, row p) a group adds u_p u_l to
// [p][pos_l] for the element's slots l with pos_l <= p, all loads of an
// entry before its stores (an element's positions are distinct).  Rows are
// disjoint between groups and entries of one row are added in element
// order, so every entry is summed in a fixed order without atomics (the
// masks are built with atomicOr, whose result is the same in any order):
// two launches give the same bits.  The band is then written once, a row a
// warp, coalesced, with D on the diagonal and rhs_vert in row F1-1 added in
// the same store.  No device memory is touched but the inputs, read once a
// band, and the band's lower triangle, written once.  What is left (NVIDIA
// H100 80GB HBM3, 700 W; n=1e6, m=40, float32): storing the lower
// triangles of square fronts leaves the rest of each DRAM page unwritten
// and runs at 1.27 TB/s even in a kernel that only stores (1.41 ms for the
// leaf's, scripts/torch_triangle_stores.py), which the bands' zeroing and
// stores take; the walk, bound by shared-memory accesses at scattered
// addresses, takes about as long again.
//
// H3 extend_add replaces the assembly halves of `_level_kernel` (:344,
// `fused_level`) and `_afront_kernel` (:756, `assemble_fronts`), and the
// forward of linalg/pallas_eadd.py `_fwd_kernel` (:98, `eadd_fronts`):
// front[i][j] = sum_s upd_s[ext_s[i]][ext_s[j]] + D + the RHS row/column,
// reading each symmetric child block through its lower triangle and
// writing the front's lower triangle.  A pure gather, bound by device-memory
// bandwidth: the parent's lower triangles written once and the children's
// read once (11.2 GB over the 13 internal levels at n=1e6, m=40, float32,
// 7.35 GB of it the parents').  Lower-triangle rows of square fronts store
// at 1.14-1.57 TB/s on an NVIDIA H100 80GB HBM3 at 700 W (the rest of each
// DRAM page is not written; scripts/torch_triangle_stores.py), so the
// parents' triangles alone take about 5.8 ms.
// Design: one block per 64 x 64 tile of one front's lower triangle (grid:
// lower-triangle tiles x fronts, as H4's symmetric update); the tile's rows'
// child positions are staged in shared memory once and a lane keeps its
// two columns' in registers; a warp takes 8 rows of the tile and issues all
// its child loads before any store, then writes contiguous 64-wide row
// segments.  ext is monotone on its valid positions, so below the diagonal
// the child row is the parent row's: a warp reads along one child row.  A
// child absent from a row skips that row's reads (warp-uniform), one absent
// from a column skips the lane's.  Index arithmetic inside a front and
// inside a child block is 32-bit (the wrapper checks both fit).  Each entry
// is summed as the plain version sums it: child 0, child 1, D, then the RHS
// row, with no products, so the result equals the plain version's bit for
// bit.
//
// H4 front_factor replaces linalg/pallas_frontal.py `_factor_kernel`
// (:180, `factor_fronts`), the factor and Schur halves of the leaf and level
// kernels (`_factor_core`, `_finish`) and the Schur einsum of
// linalg/multifrontal.py:628-629.  A partial Cholesky over the first P
// columns, in place: L_pp in the lower [:P, :P], L_bp_aug = A_bp L_pp^{-T}
// in [P:, :P] (its last row is y) and upd_aug = A_bb - L_bp L_bp^T in the
// lower triangle of [P:, P:].  What bounds it on an H100 changes with the
// level.  The wide middle levels (few fronts of ~5000, P ~ 400-1700) are
// bound by operations: the Schur product B1^2 P is most of their work.
// The leaf (thousands of fronts of ~330, P ~ 100) is bound by bytes: each
// front's lower triangle is read and written once and its products are
// short.  The root
// (one front, no border) is bound by the serial chain of its panels.
// Design: a blocked right-looking factor in two levels.  Outer panels of
// OW pivot columns; inside one, 32-wide inner panels (diagonal tile: one
// warp per front, a row a lane in registers, columns passed by shuffles;
// panel TRSM: one thread per row, the rows staged through shared memory so
// that device-memory accesses coalesce; update of the outer panel's
// remaining columns: 64 x 64 shared-memory tiles) touch only the thin slab
// of that outer panel.  After an outer panel one symmetric
// update C -= A A^T of depth OW brings the remaining pivot columns up to
// date, and after the last panel ONE such update of depth P forms the Schur
// block, so each front's [P:, P:] is read and written once (a sweep that
// updates it once per 32 pivots moves 8x the bytes at the middle levels).
// That update is a register-tiled product: 256 threads, 128 x 128 outputs
// a block and 8 x 8 a thread (64 x 64 and 4 x 4 where fewer than 192 rows
// are left to update), k slabs staged transposed in shared memory, the
// next slab copied asynchronously (cp.async) while the current one is
// multiplied, one barrier a slab; lower-triangle tiles only.  Each kernel
// launches once over ALL fronts of the level (grid: tiles x fronts), so
// the same code path fills the card at the leaf (N = 8192) and at the
// root's trailing updates.  Rows of a front start at any address (F1 is
// odd at most levels), so device-memory accesses are scalar and ragged
// edges are masked.  Every launch reads columns disjoint from those it
// writes.  All kernels read and write lower triangles only; the upper
// triangle of a front is never initialized.  Pivots are not clamped: a
// non-SPD front gives NaN in that front alone.  What is left: the product
// runs at about half the SIMT peak (the middle levels); the leaf's thin
// panel kernels move its strip several times (a strip kept in shared
// memory would not); the root's 330 small dependent launches (P = 3494:
// 110 diagonal tiles, 110 TRSMs, 82 inner and 28 symmetric updates).
//
// H9 front_factor_bwd is the pullback of H4, in place: the custom VJPs of
// linalg/pallas_frontal.py `factor_fronts` (K7, :241-270) and of the factor
// halves of `fused_level` / `fused_leaf` (K4/K5, pallas_level.py:422-484,
// :645-687), which the JAX package computes in XLA (`_factor_pullback`,
// `_chol_vjp`: four triangular solves and five products on front-sized
// temporaries).  In: the front as H4 left it (L_pp, L_bp_aug in the lower
// [:, :P]) with the symmetric cotangent of the Schur block in the lower
// triangle of [P:, P:], and the cotangents of logdet and quad.  Out: the
// front's symmetric cotangent 1/2 (X + X^T) in its lower triangle.  The
// partial factor is the first P columns of a Cholesky of the F1 x F1
// front, so its pullback is I. Murray's blocked reverse sweep
// ("Differentiation of the Cholesky decomposition", arXiv:1602.07527, the
// left-looking blocked algorithm) over those P columns, after the Schur
// product's reverse Lbar_bp -= 2 dupd_s L_bp.  What bounds it on an H100
// is operations: the symmetric-times-panel product B1^2 P at every level
// but the root, and 2 F1 P^2 - 4/3 P^3 in the sweep's two panel products.
// Design: no front-sized temporary.  The accumulating cotangent Abar of
// the first P columns lives transposed in the free upper triangle
// (G[c][r] = Abar[r][c], r > c; its diagonal in an (N, P) buffer), where
// its columns are rows, contiguous.  Column blocks of H9_BW from the last:
// a triangular solve of the block's panel cotangent by its diagonal block
// (one thread a row, the row in registers), Xbar^T C (a product of depth
// F1 - k into a (N, 64, 64) buffer), the reverse of the 64 x 64 diagonal
// block in closed form (one block a front: a product and two triangular
// sweeps, a column or a row of 64 a thread in registers), then the two panel
// products Rbar -= [Esym; Xbar]^T [R; B] and Bbar -= Xbar R.  Once a block
// is done L's columns there are dead, and its cotangent goes to the lower
// triangle.  Every product is one register-tiled SIMT kernel (64 x 64 or
// 128 x 128 outputs a block, 4 x 4 or 8 x 8 a thread, k slabs staged
// transposed in shared memory through registers while the slab before is
// multiplied) that reads its operands through strides (the symmetric Schur
// cotangent through its lower triangle) and splits a deep product over
// blocks when the output is too small to fill the card; the partial sums
// are added in a fixed order, so there are no atomics and two runs give the
// same bits.  What is left: the products run SIMT in float32 (no tensor
// cores), and the root's 55 blocks are a chain of small launches.
//
// H6 extend_add_bwd replaces K8b, linalg/pallas_eadd.py `_bwd_kernel`
// (pallas_call at :117, `_eadd_bwd_impl`), and the `dch` halves of the level
// and assembly VJPs (pallas_level.py:436-486, 831-883): each child's
// Schur-block cotangent dupd_s[a][b] += dfront[inv_s(a)][inv_s(b)], with
// inv_s the child -> parent position map (the transpose of ext), plus the
// cotangents of the diagonal adds (diag dfront) and of the RHS vector
// (row + column F1-1).  K8b forms G^T dfront G with two one-hot matmuls on
// the MXU; here it is what it computes, a pure gather, bound by device
// memory, and the exact transpose of H3: one block per 64 x 64 tile of a
// child block's lower triangle (grid: tiles x fronts x children), the
// tile's rows' parent positions in shared memory, a lane's two columns' in
// registers, all of a thread's loads before its stores.  inv is monotone,
// so a lower entry reads a lower entry of dfront, which is all H9 writes;
// the sums go through strides into the child fronts' [P_c:, P_c:] blocks,
// where H9 reads them next, so no (N, 2, Bc1, Bc1) array is allocated.
//
// H7 leaf_assemble_bwd replaces the `du` half of the leaf VJP
// (pallas_level.py:655-685): for front = sum_e a_e a_e^T, d a_e =
// 2 dfront a_e read at the element's K positions and at F1-1 (its RHS
// weight).  The JAX package scatters each element into a dense (EL, F1) row
// and multiplies by dfront (2e11 FLOP at n=1e6, m=40); here one thread per
// (element, slot) walks the slot's front row at the element's K+1
// positions, (K+1)^2 scattered reads per element (1.8e9 at n=1e6, m=40),
// and is bound by those reads; it reads dfront's lower triangle (an entry
// above the diagonal is read at its mirror), as H9 leaves it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NB = 32;       // inner panel width
constexpr int OW = 128;      // outer panel width (a multiple of NB)
constexpr int TS = 64;       // inner update tile (TS x TS outputs)
constexpr int TM = 4;        // per-thread outputs (TM x TM)
constexpr int TT = TS / TM;  // threads per tile side
constexpr int UPD_THREADS = TT * TT;
constexpr int TRSM_ROWS = 128;
constexpr int SY_THREADS = 256;  // symmetric update: 16 x 16 threads
constexpr int SY_SMALL = 192;    // row extent below which it takes 64-tiles
// blocks an SM should hold: 2 of the float32 128-tile (128 registers a
// thread, no spills), else what the registers allow
#define SY_BLOCKS(T, BT) ((sizeof(T) == 4 && (BT) == 128) ? 2 : 1)
static_assert(UPD_THREADS % 32 == 0, "whole warps per update block");
constexpr int LA_THREADS = 256;  // leaf assembly: 8 warps a band
constexpr int LA_WARPS = LA_THREADS / 32;
constexpr int LA_BAND_BYTES = 64 * 1024;   // a band's accumulator about
constexpr int LA_STAGE_BYTES = 24 * 1024;  // a chunk's slots and lists about
constexpr int LA_CHUNK = 32;     // elements a chunk at most (a row's mask)
constexpr int LA_PF = 8;         // a thread's slots of a chunk at most
constexpr int LA_G = 16;         // lanes a group of the walk
constexpr int LA_GS = 64 / LA_G; // slots a lane of a group keeps in registers
static_assert(32 % LA_G == 0, "whole groups a warp");
constexpr int EA_TILE = 64;      // extend-add: 64 x 64 tiles
constexpr int EA_THREADS = 256;
static_assert(EA_TILE % (EA_THREADS / 32) == 0 && EA_TILE % 32 == 0,
              "whole rows a warp and whole columns a lane");
static_assert(OW % NB == 0, "whole inner panels per outer panel");
constexpr int H9_BW = 64;        // H9: column block
constexpr int H9_LD = H9_BW + 4; // its rows in shared memory: 16-byte aligned
constexpr int H9_TRSM_ROWS = 128;
constexpr int H9_THREADS = 256;  // H9's seed and final kernels
constexpr int GM_THREADS = 256;  // H9's products: 16 x 16 threads
constexpr int GM_SPLIT_DEPTH = 256;  // least depth a split of a product gets
constexpr int GM_FILL = 2 * 132;     // blocks below which a product splits

// Rows [band_start(b), band_start(b + 1)) form band b of R: the least r
// with r (r + 1) / 2 * R >= b * F1 (F1 + 1) / 2, so the bands' lower-triangle
// areas differ by at most one row.  Exact integer arithmetic, the same on
// the host (which sizes shared memory from it) and on the device.
__host__ __device__ inline int band_start(int b, int R, int F1) {
  const long long need = (long long)F1 * (F1 + 1) / 2 * b;
  int r = (int)sqrt(2.0 * (double)need / R);
  while (r > 0 && (long long)(r - 1) * r / 2 * R >= need) --r;
  while ((long long)r * (r + 1) / 2 * R < need) ++r;
  return r;
}

template <typename T>
__global__ void __launch_bounds__(LA_THREADS)
leaf_assemble_kernel(const T* __restrict__ u, const int* __restrict__ epos,
                     const T* __restrict__ rhs_elem, const T* __restrict__ dv,
                     const T* __restrict__ rv, int EL, int K, int F1, int R,
                     int CH, int acc_len, int rows_max,
                     T* __restrict__ front) {
  constexpr unsigned ALL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char la_smem[];
  const int K1 = K + 1;
  T* acc = reinterpret_cast<T*>(la_smem);           // the band, packed rows
  T* val = acc + acc_len;                           // the chunk's CH x K1 slots
  int* pos = reinterpret_cast<int*>(val + CH * K1);
  int* list = pos + CH * K1;                        // (e << 16 | k), row-major
  unsigned* mask = reinterpret_cast<unsigned*>(list + CH * K1);
  int* off = reinterpret_cast<int*>(mask + rows_max);  // rows' list starts
  const int n = blockIdx.x;
  const int r0 = band_start(blockIdx.y, R, F1);
  const int r1 = band_start(blockIdx.y + 1, R, F1);
  const int rows = r1 - r0;
  const int base = r0 * (r0 + 1) / 2;
  const int area = r1 * (r1 + 1) / 2 - base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p = tid; p < area; p += LA_THREADS) acc[p] = T(0);
  for (int r = tid; r < rows; r += LA_THREADS) mask[r] = 0u;
  const T* un = u + (long)n * EL * K;
  const int* pn = epos + (long)n * EL * K;
  const T* rn = rhs_elem + (long)n * EL;
  // slot t of a chunk is (element, slot) = (t / K1, t % K1); the quotient
  // by a multiply-high, exact for t K1 < 2^32
  const unsigned magic = (unsigned)((0x100000000ull + K1 - 1) / K1);
  int pr[LA_PF];
  T vr[LA_PF];
  auto load_chunk = [&](int e0) {   // this thread's slots into registers
    const int S = (EL - e0 < CH ? EL - e0 : CH) * K1;
#pragma unroll
    for (int q = 0; q < LA_PF; ++q) {
      const int t = tid + LA_THREADS * q;
      pr[q] = -1;
      vr[q] = T(0);
      if (t < S) {
        const int e = __umulhi((unsigned)t, magic), k = t - e * K1;
        if (k < K) {
          pr[q] = pn[(e0 + e) * K + k];
          vr[q] = un[(e0 + e) * K + k];
        } else {
          pr[q] = F1 - 1;
          vr[q] = rn[e0 + e];
        }
      }
    }
  };
  if (EL > 0) load_chunk(0);
  for (int e0 = 0; e0 < EL; e0 += CH) {
    const int S = (EL - e0 < CH ? EL - e0 : CH) * K1;
    __syncthreads();                    // the previous chunk is consumed
#pragma unroll
    for (int q = 0; q < LA_PF; ++q) {
      const int t = tid + LA_THREADS * q;
      if (t < S) {
        pos[t] = pr[q];
        val[t] = vr[q];
        if (pr[q] >= r0 && pr[q] < r1)
          atomicOr(&mask[pr[q] - r0], 1u << __umulhi((unsigned)t, magic));
      }
    }
    if (e0 + CH < EL) load_chunk(e0 + CH);
    __syncthreads();
    if (warp == 0) {                    // off[r]: entries of the rows before r
      const int per = (rows + 31) / 32, lo = lane * per;
      int cnt = 0;
      for (int r = lo; r < lo + per && r < rows; ++r) cnt += __popc(mask[r]);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(ALL, incl, d);
        if (lane >= d) incl += o;
      }
      int run = incl - cnt;
      for (int r = lo; r < lo + per && r < rows; ++r) {
        off[r] = run;
        run += __popc(mask[r]);
      }
      if (lane == 31) off[rows] = incl;
    }
    __syncthreads();
    for (int t = tid; t < S; t += LA_THREADS) {
      const int p = pos[t];
      if (p >= r0 && p < r1) {
        const int e = __umulhi((unsigned)t, magic), k = t - e * K1;
        const int r = p - r0;
        list[off[r] + __popc(mask[r] & ((1u << e) - 1u))] = (e << 16) | k;
      }
    }
    __syncthreads();
    for (int r = tid; r < rows; r += LA_THREADS) mask[r] = 0u;
    // warp w walks the rows that start in [w, w + 1) / LA_WARPS of the
    // list, and each of its groups a run of them of about equal count: a
    // row is never split
    const int total = off[rows];
    auto row_start = [&](int target) {  // the first row start >= target
      for (int c = 0; c <= rows; c += 32) {
        const int o = c + lane <= rows ? off[c + lane] : total;
        const unsigned m = __ballot_sync(ALL, o >= target);
        if (m) return __shfl_sync(ALL, o, __ffs(m) - 1);
      }
      return total;
    };
    const int A = row_start((int)((long)total * warp / LA_WARPS));
    const int B = warp == LA_WARPS - 1
                      ? total
                      : row_start((int)((long)total * (warp + 1) / LA_WARPS));
    const int grp = lane / LA_G, sub = lane % LA_G;
    const unsigned gmask = ((1u << LA_G) - 1u) << (LA_G * grp);
    int gA = A, gB = B;
    for (int g = 1; g < 32 / LA_G; ++g) {
      const int c = min(B, row_start(A + (int)((long)(B - A) * g / (32 / LA_G))));
      if (grp == g) gA = c;
      if (grp == g - 1) gB = c;
    }
    for (int idx = gA; idx < gB; ++idx) {
      const int c = list[idx], e = c >> 16, k = c & 0xffff;
      const int* pe = pos + e * K1;
      const T* ve = val + e * K1;
      const int prow = pe[k];
      const T urow = ve[k];
      T* arow = acc + (prow * (prow + 1) / 2 - base);
      int pl[LA_GS];
      T ul[LA_GS], av[LA_GS];
#pragma unroll
      for (int q = 0; q < LA_GS; ++q) {
        const int l = sub + LA_G * q;
        pl[q] = l < K1 ? pe[l] : -1;
        ul[q] = l < K1 ? ve[l] : T(0);
        if (pl[q] > prow) pl[q] = -1;
        av[q] = pl[q] >= 0 ? arow[pl[q]] : T(0);
      }
#pragma unroll
      for (int q = 0; q < LA_GS; ++q)
        if (pl[q] >= 0) arow[pl[q]] = av[q] + urow * ul[q];
      for (int l = sub + LA_G * LA_GS; l < K1; l += LA_G) {
        const int pk = pe[l];
        if (pk >= 0 && pk <= prow) arow[pk] += urow * ve[l];
      }
      __syncwarp(gmask);                // the next entry may read what this wrote
    }
  }
  __syncthreads();
  T* out = front + (long)n * F1 * F1;
  const T* dn = dv + (long)n * F1;
  const T* rvn = rv + (long)n * F1;
  for (int i = r0 + warp; i < r1; i += LA_WARPS) {
    const T* arow = acc + (i * (i + 1) / 2 - base);
    T* orow = out + i * F1;
    for (int j = lane; j <= i; j += 32) {
      T v = arow[j];
      if (j == i) v += dn[i];
      if (i == F1 - 1) v += rvn[j];
      orow[j] = v;
    }
  }
}

// Block b of a launch over the lower-triangle tiles (ti, tj), tj <= ti, of
// a region whose tile columns stop at ntj: the first ntj tile rows form a
// triangle, enumerated row by row, the rest are full rows of ntj tiles.
__device__ __forceinline__ void tile_of(int b, int ntj, int& ti, int& tj) {
  const int tri = ntj * (ntj + 1) / 2;
  if (b < tri) {
    ti = (int)((sqrtf(8.0f * b + 1.0f) - 1.0f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= b) ++ti;
    while (ti * (ti + 1) / 2 > b) --ti;
    tj = b - ti * (ti + 1) / 2;
  } else {
    b -= tri;
    ti = ntj + b / ntj;
    tj = b - (b / ntj) * ntj;
  }
}

// number of blocks of such a launch: rows [r0, F1), columns [r0, c1)
inline int tile_count(int F1, int r0, int c1, int tile) {
  const int nti = (F1 - r0 + tile - 1) / tile;
  const int ntj = (c1 - r0 + tile - 1) / tile;
  return ntj * (ntj + 1) / 2 + (nti - ntj) * ntj;
}

template <typename T>
__global__ void __launch_bounds__(EA_THREADS)
extend_add_kernel(const T* __restrict__ upd, long s_node, long s_child,
                  int s_row, const int* __restrict__ ext,
                  const T* __restrict__ dv, const T* __restrict__ rv, int F1,
                  T* __restrict__ front) {
  constexpr int NW = EA_THREADS / 32;
  constexpr int RW = EA_TILE / NW;                 // rows a warp
  constexpr int CL = EA_TILE / 32;                 // columns a lane
  __shared__ int ra[2][EA_TILE];                   // the tile's rows' positions
  const long n = blockIdx.y;
  int ti, tj;
  tile_of((int)blockIdx.x, (F1 + EA_TILE - 1) / EA_TILE, ti, tj);
  const int i0 = ti * EA_TILE, j0 = tj * EA_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* e0 = ext + n * 2 * F1;
  const int* e1 = e0 + F1;
  const T* c0 = upd + n * s_node;
  const T* c1 = c0 + s_child;
  T* out = front + n * F1 * F1;
  for (int t = threadIdx.x; t < 2 * EA_TILE; t += EA_THREADS) {
    const int s = t / EA_TILE, i = i0 + t - s * EA_TILE;
    ra[s][t - s * EA_TILE] = i < F1 ? (s ? e1[i] : e0[i]) : -1;
  }
  int b0[CL], b1[CL];
#pragma unroll
  for (int c = 0; c < CL; ++c) {
    const int j = j0 + lane + 32 * c;
    b0[c] = j < F1 ? e0[j] : -1;
    b1[c] = j < F1 ? e1[j] : -1;
  }
  __syncthreads();
  // all the children's values first (the children's lower triangles), then
  // the sums and stores
  T v[RW][CL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = i0 + warp + NW * r;
    const int a0 = ra[0][warp + NW * r], a1 = ra[1][warp + NW * r];
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      const int j = j0 + lane + 32 * c;
      const bool in = j <= i && i < F1;
      T acc = T(0);
      if (in && a0 >= 0 && b0[c] >= 0)
        acc += c0[(a0 > b0[c] ? a0 : b0[c]) * s_row + (a0 > b0[c] ? b0[c] : a0)];
      if (in && a1 >= 0 && b1[c] >= 0)
        acc += c1[(a1 > b1[c] ? a1 : b1[c]) * s_row + (a1 > b1[c] ? b1[c] : a1)];
      v[r][c] = acc;
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = i0 + warp + NW * r;
    if (i >= F1) continue;
    T* orow = out + i * F1;
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      const int j = j0 + lane + 32 * c;
      if (j > i) continue;                 // lower triangle only
      T acc = v[r][c];
      if (i == j) acc += dv[n * F1 + i];
      if (i == F1 - 1) acc += rv[n * F1 + j];
      orow[j] = acc;
    }
  }
}

// diagonal tile of panel k0 (width kb <= NB): one warp per front, lane =
// row, the row in registers; column k of the factor reaches the other lanes
// by shuffles.  Rows and columns past kb are those of the identity.
template <typename T>
__global__ void panel_diag_kernel(T* __restrict__ front, int F1, int k0,
                                  int kb) {
  constexpr unsigned ALL = 0xffffffffu;
  T* A = front + (long)blockIdx.x * F1 * F1;
  const int lane = threadIdx.x;
  T* row = A + (long)(k0 + lane) * F1 + k0;
  T r[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    r[j] = (lane < kb && j <= lane) ? row[j] : (j == lane ? T(1) : T(0));
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const T inv = T(1) / sqrt(__shfl_sync(ALL, r[k], k));
    if (lane >= k) r[k] *= inv;
#pragma unroll
    for (int j = k + 1; j < NB; ++j) {
      const T ljk = __shfl_sync(ALL, r[k], j);
      if (lane >= j) r[j] -= r[k] * ljk;
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (lane < kb && j <= lane) row[j] = r[j];
}

// panel TRSM: rows r >= k0+kb solve x L11^T = A[r, k0:k0+kb].  A block
// stages its rows' panel entries in shared memory through coalesced loads
// (lane = column), one thread solves one row there against L11 (its
// diagonal kept inverted), and the block stores the rows back coalesced.
template <typename T>
__global__ void panel_trsm_kernel(T* __restrict__ front, int F1, int k0,
                                  int kb) {
  __shared__ T L[NB][NB + 1];
  __shared__ T X[TRSM_ROWS][NB + 1];
  T* A = front + (long)blockIdx.y * F1 * F1;
  for (int t = threadIdx.x; t < NB * NB; t += blockDim.x) {
    const int i = t / NB, j = t - (t / NB) * NB;
    T v = (i < kb && j <= i) ? A[(long)(k0 + i) * F1 + k0 + j] : T(0);
    if (i == j) v = i < kb ? T(1) / v : T(1);
    L[i][j] = v;
  }
  const int rb = k0 + kb + blockIdx.x * TRSM_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < TRSM_ROWS; c += TRSM_ROWS / 32)
    X[c][lane] = (lane < kb && rb + c < F1)
                     ? A[(long)(rb + c) * F1 + k0 + lane] : T(0);
  __syncthreads();
  T x[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    T s = X[threadIdx.x][j];
#pragma unroll
    for (int l = 0; l < j; ++l) s -= x[l] * L[j][l];
    x[j] = s * L[j][j];
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) X[threadIdx.x][j] = x[j];
  __syncthreads();
  for (int c = warp; c < TRSM_ROWS; c += TRSM_ROWS / 32)
    if (lane < kb && rb + c < F1)
      A[(long)(rb + c) * F1 + k0 + lane] = X[c][lane];
}

// inner update of one 32-wide panel: rows >= k0+kb, columns [k0+kb, c1)
// (the rest of the outer panel), lower-triangle tiles only.
// A TS x TS tile per block, TM x TM outputs per thread; the two L21 panels
// are staged in shared memory with rows padded to TS+1, so both the
// coalesced staging stores and the compute loads are free of bank conflicts,
// and each thread does TM*TM FMAs per 2*TM shared loads.
template <typename T>
__global__ void panel_update_kernel(T* __restrict__ front, int F1, int k0,
                                    int kb, int c1) {
  __shared__ T Li[NB][TS + 1];
  __shared__ T Lj[NB][TS + 1];
  T* A = front + (long)blockIdx.y * F1 * F1;
  const int r0 = k0 + kb;
  int ti, tj;
  tile_of((int)blockIdx.x, (c1 - r0 + TS - 1) / TS, ti, tj);
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
      if (j < c1 && j <= i) A[(long)i * F1 + j] -= acc[p][q];
    }
  }
}

// four consecutive values from shared memory, 16-byte loads
__device__ __forceinline__ void ld4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double* out) {
  const double2 v = reinterpret_cast<const double2*>(p)[0];
  const double2 w = reinterpret_cast<const double2*>(p)[1];
  out[0] = v.x; out[1] = v.y; out[2] = w.x; out[3] = w.y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// asynchronous copy of one value from device to shared memory, or a 0
// written there when ``valid`` is false (no byte of src is read then)
__device__ __forceinline__ void cp_async_or_zero(unsigned dst, const float* src,
                                                 bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_or_zero(unsigned dst,
                                                 const double* src,
                                                 bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// Symmetric update C[i][j] -= sum_{k in [k0, k1)} A[i][k] A[j][k] over rows
// i in [r0, F1) and columns j in [r0, c1), j <= i, with k1 <= r0: the read
// columns [k0, k1) and the written ones are disjoint.  One BT x BT tile a
// block (grid: lower-triangle tiles x fronts), 16 x 16 threads of TM x TM
// outputs, TM = BT / 16; a thread's rows and columns come in groups of 4
// consecutive ones, so its shared-memory loads are 16 bytes and a warp's
// are contiguous.  k runs in slabs of KS; a slab of the row operand and one
// of the column operand sit in shared memory transposed ([k][row], rows
// padded by 4 so that the staging stores of a warp, 4 rows x 8 k, fall
// into 32 distinct banks), in two buffers: asynchronous copies (cp.async,
// one value each, since a front's rows start at any address) bring the
// next slab into the other buffer while the current one is multiplied, one
// barrier a slab.  Rows past F1 and k past k1 are staged as 0.
template <typename T, int BT>
__global__ void __launch_bounds__(SY_THREADS, SY_BLOCKS(T, BT))
syrk_update_kernel(T* front, int F1, int r0, int c1, int k0, int k1) {
  // slab depth; 8 where two buffers of 16 would pass 48 KB (f64, BT 128)
  constexpr int KS = (sizeof(T) == 8 && BT == 128) ? 8 : 16;
  constexpr int S = BT + 4;                // padded slab row
  constexpr int TMS = BT / 16;             // outputs a thread and side
  constexpr int G = TMS / 4;               // groups of 4 a thread and side
  constexpr int GS = BT / G;               // distance between groups
  static_assert(TMS % 4 == 0 && BT % 32 == 0 && KS % 8 == 0, "tile shape");
  __shared__ __align__(16) T Ai[2][KS][S];
  __shared__ __align__(16) T Aj[2][KS][S];
  T* A = front + (long)blockIdx.y * F1 * F1;
  int ti, tj;
  tile_of((int)blockIdx.x, (c1 - r0 + BT - 1) / BT, ti, tj);
  const int i0 = r0 + ti * BT, j0 = r0 + tj * BT;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  // staging: a warp's copies cover 4 rows x 8 consecutive k (lane = 8 rr +
  // kk); unit h of warp w is row-quad w + 8 (h % HR), k-octet h / HR
  constexpr int HR = BT / 32;              // row-quad steps of a warp
  constexpr int NU = HR * (KS / 8);        // units a warp stages
  const int kk = t % 8, rq = 4 * (t / 32) + (t % 32) / 8;
  const T* gi = A + (long)(i0 + rq) * F1 + kk;
  const T* gj = A + (long)(j0 + rq) * F1 + kk;
  const long F32 = 32L * F1;
  unsigned oki = 0, okj = 0;               // bit u: row rq + 32 u is in the front
#pragma unroll
  for (int u = 0; u < HR; ++u) {
    oki |= (unsigned)(i0 + rq + 32 * u < F1) << u;
    okj |= (unsigned)(j0 + rq + 32 * u < F1) << u;
  }
  const unsigned si = smem_addr(&Ai[0][kk][rq]), sj = smem_addr(&Aj[0][kk][rq]);
  auto stage = [&](int kb, int buf) {
#pragma unroll
    for (int h = 0; h < NU; ++h) {
      const bool kin = kb + 8 * (h / HR) + kk < k1;
      const bool vi = kin && (oki >> (h % HR) & 1u);
      const bool vj = kin && (okj >> (h % HR) & 1u);
      const long off = (h % HR) * F32 + 8 * (h / HR) + kb;
      const unsigned dst =
          (unsigned)(((buf * KS + 8 * (h / HR)) * S + 32 * (h % HR)) * sizeof(T));
      cp_async_or_zero(si + dst, gi + off, vi);
      cp_async_or_zero(sj + dst, gj + off, vj);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  T acc[TMS][TMS];
#pragma unroll
  for (int p = 0; p < TMS; ++p)
#pragma unroll
    for (int q = 0; q < TMS; ++q) acc[p][q] = T(0);

  stage(k0, 0);
  int buf = 0;
  for (int kb = k0; kb < k1; kb += KS) {
    // this slab has landed; the barrier also frees the other buffer, which
    // every thread has finished multiplying
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (kb + KS < k1) stage(kb + KS, buf ^ 1);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      T a[TMS], b[TMS];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ld4(&Ai[buf][k][g * GS + 4 * ty], a + 4 * g);
        ld4(&Aj[buf][k][g * GS + 4 * tx], b + 4 * g);
      }
#pragma unroll
      for (int p = 0; p < TMS; ++p)
#pragma unroll
        for (int q = 0; q < TMS; ++q) acc[p][q] += a[p] * b[q];
    }
    buf ^= 1;
  }

  // C -= acc, one row of the thread's outputs at a time: its loads come
  // before its stores.  C is read and written through one pointer, so
  // the compiler keeps every load behind the store before it, and single
  // read-modify-writes would wait out the memory's latency once an entry.
#pragma unroll
  for (int p = 0; p < TMS; ++p) {
    const int i = i0 + (p / 4) * GS + 4 * ty + p % 4;
    if (i >= F1) continue;
    T* row = A + (long)i * F1 + j0;
    T v[TMS];
#pragma unroll
    for (int q = 0; q < TMS; ++q) {
      const int c = (q / 4) * GS + 4 * tx + q % 4;
      v[q] = (j0 + c < c1 && j0 + c <= i) ? row[c] : T(0);
    }
#pragma unroll
    for (int q = 0; q < TMS; ++q) {
      const int c = (q / 4) * GS + 4 * tx + q % 4;
      if (j0 + c < c1 && j0 + c <= i) row[c] = v[q] - acc[p][q];
    }
  }
}

// ---------------------------------------------------------------- H9 ----

// seed: rows c < P of the upper triangle hold G = Abar^T; Abar starts as
// Lbar: 0 but for 2 g_quad y in row F1-1 (G's column F1-1), and its
// diagonal 2 g_logdet / L_cc in gdiag.  One warp a row.
template <typename T>
__global__ void h9_seed_kernel(T* __restrict__ front, int F1, int P,
                               const T* __restrict__ gl,
                               const T* __restrict__ gq,
                               T* __restrict__ gdiag) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (H9_THREADS / 32) + warp;
  if (c >= P) return;
  T* A = front + (long)blockIdx.y * F1 * F1;
  T* row = A + (long)c * F1;
  const T y2 = T(2) * gq[0] * A[(long)(F1 - 1) * F1 + c];
  for (int col = c + 1 + lane; col < F1; col += 32)
    row[col] = col == F1 - 1 ? y2 : T(0);
  if (lane == 0) gdiag[(long)blockIdx.y * P + c] = T(2) * gl[0] / row[c];
}

// whether a slab's staging runs along k (else along x): where k is
// contiguous in memory; a symmetric operand's slab wholly above its
// diagonal (k < x) is read transposed
template <int KS, bool SYM>
__device__ __forceinline__ bool gm_kfast(long sx, long sk, int x0, int k0) {
  if (SYM && k0 + KS <= x0) return sx == 1;
  return sk == 1;
}

// a thread's R values of a BT x KS slab of an operand whose element (x, k)
// is p[x sx + k sk] (SYM: p[k sx + x sk] where k < x, the mirror of the
// lower triangle); 0 past xlim and klim
template <typename T, int BT, int KS, bool SYM>
__device__ __forceinline__ void gm_load(T* r, const T* p, long sx, long sk,
                                        int x0, int xlim, int k0, int klim,
                                        bool kfast) {
  constexpr int R = BT * KS / GM_THREADS;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int e = threadIdx.x + GM_THREADS * u;
    const int xx = kfast ? e / KS : e % BT, kk = kfast ? e % KS : e / BT;
    const int x = x0 + xx, k = k0 + kk;
    T v = T(0);
    if (x < xlim && k < klim)
      v = (SYM && k < x) ? p[x * sk + k * sx] : p[x * sx + k * sk];
    r[u] = v;
  }
}

// ... stored transposed, [k][x]
template <typename T, int BT, int KS, int S>
__device__ __forceinline__ void gm_store(T (*sm)[S], const T* r, bool kfast) {
  constexpr int R = BT * KS / GM_THREADS;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int e = threadIdx.x + GM_THREADS * u;
    const int xx = kfast ? e / KS : e % BT, kk = kfast ? e % KS : e / BT;
    sm[kk][xx] = r[u];
  }
}

// H9's products: C = (beta ? C : 0) + alpha A B over N fronts, A (M x K)
// with element (m, k) at a[n a_n + m a_sx + k a_sk], B (K x Nn) with
// element (k, x) at b[n b_n + x b_sx + k b_sk] (SYM: B symmetric, read
// through its lower triangle k >= x), C (M x Nn) at c[n c_n + m c_rs +
// x c_cs].  The operands and C lie in the same fronts (disjoint regions),
// so nothing is __restrict__.  One BT x BT tile of C a block (grid: tiles x
// splits x fronts), 16 x 16 threads of TMS x TMS outputs in groups of 4
// consecutive rows and columns (16-byte shared loads), k slabs of KS staged
// transposed in shared memory (rows padded by 4) in two buffers: the next
// slab comes into registers while the current one is multiplied.  With
// splits, block (tile, s) sums k in [s kchunk, (s + 1) kchunk) into
// work[n][s] (M x Nn), which h9_reduce_kernel adds in order of s.
template <typename T, int BT, bool SYM>
__global__ void __launch_bounds__(GM_THREADS)
h9_gemm_kernel(const T* a, long a_n, long a_sx, long a_sk, const T* b,
               long b_n, long b_sx, long b_sk, T* c, long c_n, long c_rs,
               long c_cs, int M, int Nn, int K, int kchunk, int tiles_n,
               T alpha, int beta, T* work) {
  constexpr int KS = BT == 128 ? 8 : 16;
  constexpr int S = BT + 4;
  constexpr int TMS = BT / 16, G = TMS / 4, GS = BT / G;
  constexpr int R = BT * KS / GM_THREADS;
  static_assert(R * GM_THREADS == BT * KS && TMS % 4 == 0, "slab shape");
  __shared__ __align__(16) T As[2][KS][S];
  __shared__ __align__(16) T Bs[2][KS][S];
  const long n = blockIdx.z;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x - tm * tiles_n;
  const int m0 = tm * BT, n0 = tn * BT;
  const int kb0 = split * kchunk, kb1 = min(K, kb0 + kchunk);
  const T* pa = a + n * a_n;
  const T* pb = b + n * b_n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T acc[TMS][TMS];
#pragma unroll
  for (int p = 0; p < TMS; ++p)
#pragma unroll
    for (int q = 0; q < TMS; ++q) acc[p][q] = T(0);
  T ra[R], rb[R];
  bool kfa = gm_kfast<KS, false>(a_sx, a_sk, m0, kb0);
  bool kfb = gm_kfast<KS, SYM>(b_sx, b_sk, n0, kb0);
  gm_load<T, BT, KS, false>(ra, pa, a_sx, a_sk, m0, M, kb0, kb1, kfa);
  gm_load<T, BT, KS, SYM>(rb, pb, b_sx, b_sk, n0, Nn, kb0, kb1, kfb);
  gm_store<T, BT, KS, S>(As[0], ra, kfa);
  gm_store<T, BT, KS, S>(Bs[0], rb, kfb);
  __syncthreads();
  int buf = 0;
  for (int kb = kb0; kb < kb1; kb += KS) {
    const bool next = kb + KS < kb1;
    if (next) {
      kfa = gm_kfast<KS, false>(a_sx, a_sk, m0, kb + KS);
      kfb = gm_kfast<KS, SYM>(b_sx, b_sk, n0, kb + KS);
      gm_load<T, BT, KS, false>(ra, pa, a_sx, a_sk, m0, M, kb + KS, kb1, kfa);
      gm_load<T, BT, KS, SYM>(rb, pb, b_sx, b_sk, n0, Nn, kb + KS, kb1, kfb);
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      T av[TMS], bv[TMS];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ld4(&As[buf][k][g * GS + 4 * ty], av + 4 * g);
        ld4(&Bs[buf][k][g * GS + 4 * tx], bv + 4 * g);
      }
#pragma unroll
      for (int p = 0; p < TMS; ++p)
#pragma unroll
        for (int q = 0; q < TMS; ++q) acc[p][q] += av[p] * bv[q];
    }
    if (next) {
      // the other buffer was last read before the barrier that ended the
      // slab before this one
      gm_store<T, BT, KS, S>(As[buf ^ 1], ra, kfa);
      gm_store<T, BT, KS, S>(Bs[buf ^ 1], rb, kfb);
    }
    __syncthreads();
    buf ^= 1;
  }
  T* pc = nsplit > 1 ? work + (n * nsplit + split) * (long)M * Nn
                     : c + n * c_n;
  const long rs = nsplit > 1 ? (long)Nn : c_rs, cs = nsplit > 1 ? 1 : c_cs;
#pragma unroll
  for (int p = 0; p < TMS; ++p) {
    const int m = m0 + (p / 4) * GS + 4 * ty + p % 4;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < TMS; ++q) {
      const int x = n0 + (q / 4) * GS + 4 * tx + q % 4;
      if (x >= Nn) continue;
      T* o = pc + m * rs + x * cs;
      if (nsplit > 1) *o = acc[p][q];
      else *o = (beta ? *o : T(0)) + alpha * acc[p][q];
    }
  }
}

// C = (beta ? C : 0) + alpha sum_s work[n][s], s in order
template <typename T>
__global__ void h9_reduce_kernel(const T* work, int nsplit, int M, int Nn,
                                 T* c, long c_n, long c_rs, long c_cs,
                                 T alpha, int beta) {
  const long n = blockIdx.y;
  const long MN = (long)M * Nn;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= MN) return;
  const int m = (int)(e / Nn), x = (int)(e - (long)m * Nn);
  const T* w = work + n * nsplit * MN + e;
  T s = T(0);
  for (int i = 0; i < nsplit; ++i) s += w[i * MN];
  T* o = c + n * c_n + m * c_rs + x * c_cs;
  *o = (beta ? *o : T(0)) + alpha * s;
}

// x D = c for one row x of H9_BW values in registers (c on entry, zero
// past kb), D in shared memory (the identity past kb) with its inverted
// diagonal in dinv: from the last column, x_l, then its share subtracted
// from the columns before (independent updates; D's row read 4 values a
// load, the same address in every thread)
template <typename T>
__device__ __forceinline__ void h9_solve_row(T (&x)[H9_BW],
                                             const T (*D)[H9_LD],
                                             const T* dinv) {
#pragma unroll
  for (int l = H9_BW - 1; l >= 0; --l) {
    x[l] *= dinv[l];
#pragma unroll
    for (int m4 = 0; m4 < l; m4 += 4) {
      T d[4];
      ld4(&D[l][m4], d);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (m4 + q < l) x[m4 + q] -= x[l] * d[q];
    }
  }
}

// the block's L (the identity past kb) and its inverted diagonal
template <typename T>
__device__ __forceinline__ void h9_load_diag(T (*D)[H9_LD], T* dinv,
                                             const T* A, int F1, int j,
                                             int kb) {
  // unrolled, so that a thread's loads are in flight together: these
  // kernels run few threads a front, and at the top levels few fronts
#pragma unroll 16
  for (int q = threadIdx.x; q < H9_BW * H9_BW; q += blockDim.x) {
    const int l = q / H9_BW, m = q - (q / H9_BW) * H9_BW;
    T v = (l < kb && m <= l) ? A[(long)(j + l) * F1 + j + m] : T(0);
    if (l == m && l >= kb) v = T(1);
    D[l][m] = v;
    if (l == m) dinv[l] = T(1) / v;
  }
}

// Xbar = Cbar D^{-1} for the rows i in [j + kb, F1) of the block's panel:
// G[j + l][i], l < kb, is row i's Cbar.  One thread a row, held in
// registers (``h9_solve_row``).
template <typename T>
__global__ void __launch_bounds__(H9_TRSM_ROWS)
h9_trsm_kernel(T* __restrict__ front, int F1, int j, int kb) {
  __shared__ __align__(16) T D[H9_BW][H9_LD];
  __shared__ T dinv[H9_BW];
  T* A = front + (long)blockIdx.y * F1 * F1;
  h9_load_diag(D, dinv, A, F1, j, kb);
  __syncthreads();
  const int i = j + kb + blockIdx.x * H9_TRSM_ROWS + threadIdx.x;
  if (i >= F1) return;
  T x[H9_BW];
#pragma unroll
  for (int l = 0; l < H9_BW; ++l)
    x[l] = l < kb ? A[(long)(j + l) * F1 + i] : T(0);
  h9_solve_row(x, D, dinv);
#pragma unroll
  for (int l = 0; l < H9_BW; ++l)
    if (l < kb) A[(long)(j + l) * F1 + i] = x[l];
}

// The reverse of the block's diagonal factor D = chol(E) in closed form,
// one block of H9_BW threads a front, D and the cotangent in shared
// memory: Dbar = Abar's block (G's upper triangle of the block, transposed,
// and gdiag) minus Xbar^T C (sbuf, transposed); Phi = tril(D^T Dbar) with
// its diagonal halved, S = Phi + Phi^T, and Esym = D^{-T} S D^{-1} (the JAX
// package's `_chol_vjp`, whose 1/4 (dA + dA^T) is 1/2 Esym).  Thread t holds a
// column, then a row, in registers: M's column t (D^T Dbar, a sum over
// rows with independent accumulators), then D^T X = S for X's column t
// and Esym D = X for Esym's row t, both ``h9_solve_row``.  Writes Esym,
// symmetrized, into both triangles of the block (D is dead).
template <typename T>
__global__ void __launch_bounds__(H9_BW)
h9_diag_kernel(T* __restrict__ front, int F1, int P, int j, int kb,
               const T* __restrict__ gdiag, const T* __restrict__ sbuf) {
  __shared__ __align__(16) T D[H9_BW][H9_LD];
  __shared__ T dinv[H9_BW];
  extern __shared__ __align__(16) unsigned char h9_smem[];
  T (*E)[H9_BW + 1] = reinterpret_cast<T (*)[H9_BW + 1]>(h9_smem);
  const long n = blockIdx.x;
  T* A = front + n * F1 * F1;
  const T* Sn = sbuf + n * H9_BW * H9_BW;
  const T* gd = gdiag + n * P + j;
  const int t = threadIdx.x;
  h9_load_diag(D, dinv, A, F1, j, kb);
  // Dbar, zero past kb: G's rows j + m read along l (coalesced), sbuf
  // holding S transposed
#pragma unroll 16
  for (int q = t; q < H9_BW * H9_BW; q += H9_BW) {
    const int m = q / H9_BW, l = q - (q / H9_BW) * H9_BW;
    T e = T(0);
    if (l < kb && m < l) e = A[(long)(j + m) * F1 + j + l] - Sn[m * H9_BW + l];
    else if (l < kb && m == l) e = gd[l] - Sn[l * H9_BW + l];
    E[l][m] = e;
  }
  __syncthreads();
  T v[H9_BW];
#pragma unroll
  for (int a = 0; a < H9_BW; ++a) v[a] = T(0);
#pragma unroll
  for (int i = 0; i < H9_BW; ++i) {     // M[a][t] = sum_{i >= a} D[i][a] Dbar[i][t]
    const T e = E[i][t];
#pragma unroll
    for (int a4 = 0; a4 <= i; a4 += 4) {
      T d[4];
      ld4(&D[i][a4], d);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (a4 + q <= i) v[a4 + q] += d[q] * e;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < H9_BW; ++a) E[a][t] = v[a];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < H9_BW; ++a)       // S's column t: M[a][t], a >= t; M[t][a]
    v[a] = a >= t ? E[a][t] : E[t][a];
  h9_solve_row(v, D, dinv);             // X's column t
  __syncthreads();
#pragma unroll
  for (int a = 0; a < H9_BW; ++a) E[a][t] = v[a];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < H9_BW; ++a) v[a] = E[t][a];
  h9_solve_row(v, D, dinv);             // Esym's row t
#pragma unroll
  for (int a = 0; a < H9_BW; ++a) E[t][a] = v[a];     // the thread's own row
  __syncthreads();
#pragma unroll 16
  for (int q = t; q < kb * kb; q += H9_BW) {
    const int l = q / kb, m = q - (q / kb) * kb;
    A[(long)(j + l) * F1 + j + m] = T(0.5) * (E[l][m] + E[m][l]);
  }
}

// A finished block's cotangent into the lower triangle, where L's columns
// [j, j + kb) are dead: rows i >= j + kb get 1/2 G[j + l][i] (a 64 x 64
// tile a block, transposed through shared memory), the diagonal block
// 1/2 Esym (block 0).
template <typename T>
__global__ void __launch_bounds__(H9_THREADS)
h9_final_kernel(T* __restrict__ front, int F1, int j, int kb) {
  __shared__ T tile[H9_BW][H9_BW + 1];
  T* A = front + (long)blockIdx.y * F1 * F1;
  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < kb * kb; t += H9_THREADS) {
      const int l = t / kb, m = t - (t / kb) * kb;
      if (m <= l) A[(long)(j + l) * F1 + j + m] *= T(0.5);
    }
    return;
  }
  const int i0 = j + kb + (blockIdx.x - 1) * H9_BW;
  for (int t = threadIdx.x; t < H9_BW * H9_BW; t += H9_THREADS) {
    const int l = t / H9_BW, ii = t - (t / H9_BW) * H9_BW;
    if (l < kb && i0 + ii < F1) tile[l][ii] = A[(long)(j + l) * F1 + i0 + ii];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < H9_BW * H9_BW; t += H9_THREADS) {
    const int ii = t / H9_BW, l = t - (t / H9_BW) * H9_BW;
    if (l < kb && i0 + ii < F1)
      A[(long)(i0 + ii) * F1 + j + l] = T(0.5) * tile[l][ii];
  }
}

template <typename T>
__global__ void diag_rhs_bwd_kernel(const T* __restrict__ dfront, int F1,
                                    T* __restrict__ ddv, T* __restrict__ drv) {
  const long n = blockIdx.y;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F1) return;
  const T* D = dfront + n * (long)F1 * F1;
  const T r = D[(long)(F1 - 1) * F1 + f];    // row F1-1: the lower triangle
  ddv[n * F1 + f] = D[(long)f * F1 + f];
  drv[n * F1 + f] = r + r;
}

template <typename T>
__global__ void __launch_bounds__(EA_THREADS)
extend_add_bwd_kernel(const T* __restrict__ dfront, int F1,
                      const int* __restrict__ inv, int Bc1,
                      T* __restrict__ out, long s_node, long s_child,
                      int s_row) {
  constexpr int NW = EA_THREADS / 32;
  constexpr int RW = EA_TILE / NW;                 // rows a warp
  constexpr int CL = EA_TILE / 32;                 // columns a lane
  __shared__ int ra[EA_TILE];                      // the tile's rows' parents
  const long n = blockIdx.y;
  const int s = blockIdx.z;
  int ti, tj;
  tile_of((int)blockIdx.x, (Bc1 + EA_TILE - 1) / EA_TILE, ti, tj);
  const int a0 = ti * EA_TILE, b0 = tj * EA_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* iv = inv + (n * 2 + s) * Bc1;
  const T* D = dfront + n * F1 * F1;
  T* o = out + n * s_node + s * s_child;
  for (int t = threadIdx.x; t < EA_TILE; t += EA_THREADS)
    ra[t] = a0 + t < Bc1 ? iv[a0 + t] : -1;
  int pc[CL];
#pragma unroll
  for (int c = 0; c < CL; ++c) {
    const int b = b0 + lane + 32 * c;
    pc[c] = b < Bc1 ? iv[b] : -1;
  }
  __syncthreads();
  // a >= b gives inv[a] >= inv[b] (inv is monotone): dfront's lower triangle
  T v[RW][CL], w[RW][CL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int a = a0 + warp + NW * r, pa = ra[warp + NW * r];
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      const int b = b0 + lane + 32 * c;
      const bool in = b <= a && pa >= 0 && pc[c] >= 0;
      v[r][c] = in ? D[(long)pa * F1 + pc[c]] : T(0);
      w[r][c] = in ? o[a * s_row + b] : T(0);
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int a = a0 + warp + NW * r, pa = ra[warp + NW * r];
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      const int b = b0 + lane + 32 * c;
      if (b <= a && pa >= 0 && pc[c] >= 0) o[a * s_row + b] = w[r][c] + v[r][c];
    }
  }
}

template <typename T>
__global__ void leaf_assemble_bwd_kernel(const T* __restrict__ dfront,
                                         const T* __restrict__ u,
                                         const int* __restrict__ epos,
                                         const T* __restrict__ rhs_elem,
                                         int EL, int K, int F1,
                                         T* __restrict__ du,
                                         T* __restrict__ dre) {
  const long n = blockIdx.y;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int K1 = K + 1;
  if (t >= (long)EL * K1) return;
  const long e = n * EL + t / K1;
  const int k = (int)(t % K1);
  const int* pe = epos + e * K;
  const T* ue = u + e * K;
  const int pk = (k < K) ? pe[k] : F1 - 1;
  T acc = T(0);
  if (pk >= 0) {
    // dfront's lower triangle: [pk][pl] for pl <= pk, else its mirror
    const T* Dn = dfront + n * (long)F1 * F1;
    const T* row = Dn + (long)pk * F1;
    acc = Dn[(long)(F1 - 1) * F1 + pk] * rhs_elem[e];
    for (int l = 0; l < K; ++l) {
      const int pl = pe[l];
      if (pl >= 0) acc += (pl <= pk ? row[pl] : Dn[(long)pl * F1 + pk]) * ue[l];
    }
  }
  if (k < K) du[e * K + k] = T(2) * acc;
  else dre[e] = T(2) * acc;
}

template <typename T>
int launch_diag_rhs_bwd(const T* dfront, int N, int F1, T* ddv, T* drv,
                        cudaStream_t st) {
  dim3 grid((unsigned)((F1 + 255) / 256), (unsigned)N);
  diag_rhs_bwd_kernel<T><<<grid, 256, 0, st>>>(dfront, F1, ddv, drv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_extend_add_bwd(const T* dfront, int N, int F1, const int* inv,
                          int Bc1, T* out, long s_node, long s_child,
                          long s_row, T* ddv, T* drv, cudaStream_t st) {
  if (N == 0) return 0;
  if (Bc1 > 0) {
    dim3 grid((unsigned)tile_count(Bc1, 0, Bc1, EA_TILE), (unsigned)N, 2);
    extend_add_bwd_kernel<T><<<grid, EA_THREADS, 0, st>>>(
        dfront, F1, inv, Bc1, out, s_node, s_child, (int)s_row);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return launch_diag_rhs_bwd(dfront, N, F1, ddv, drv, st);
}

template <typename T>
int launch_leaf_assemble_bwd(const T* dfront, const T* u, const int* epos,
                             const T* rhs_elem, int N, int EL, int K, int F1,
                             T* du, T* dre, T* ddv, T* drv, cudaStream_t st) {
  if (N == 0) return 0;
  const long work = (long)EL * (K + 1);
  if (work > 0) {
    dim3 grid((unsigned)((work + 255) / 256), (unsigned)N);
    leaf_assemble_bwd_kernel<T><<<grid, 256, 0, st>>>(dfront, u, epos,
                                                      rhs_elem, EL, K, F1, du,
                                                      dre);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return launch_diag_rhs_bwd(dfront, N, F1, ddv, drv, st);
}

// R bands of about LA_BAND_BYTES (at most F1 bands), the longest band's
// packed length and the most rows a band has
template <typename T>
void leaf_bands(int F1, int& R, int& acc_len, int& rows_max) {
  const long long tri = (long long)F1 * (F1 + 1) / 2;
  const long long per = LA_BAND_BYTES / sizeof(T);
  R = (int)((tri + per - 1) / per);
  if (R < 1) R = 1;
  if (R > F1) R = F1;
  acc_len = rows_max = 0;
  for (int b = 0; b < R; ++b) {
    const int r0 = band_start(b, R, F1), r1 = band_start(b + 1, R, F1);
    const int len = r1 * (r1 + 1) / 2 - r0 * (r0 + 1) / 2;
    if (len > acc_len) acc_len = len;
    if (r1 - r0 > rows_max) rows_max = r1 - r0;
  }
  acc_len += acc_len & 1;          // keep the staged values 8-byte aligned
}

template <typename T>
int launch_leaf_assemble(const T* u, const int* epos, const T* rhs_elem,
                         const T* dv, const T* rv, int N, int EL, int K,
                         int F1, T* front, cudaStream_t st) {
  if (N == 0) return 0;
  int R, acc_len, rows_max;
  leaf_bands<T>(F1, R, acc_len, rows_max);
  const int K1 = K + 1;
  // a chunk: values, positions and list entries of its slots
  const int per_elem = K1 * (int)(sizeof(T) + 2 * sizeof(int));
  int CH = LA_STAGE_BYTES / per_elem;
  if (CH > LA_CHUNK) CH = LA_CHUNK;
  if (CH * K1 > LA_PF * LA_THREADS) CH = LA_PF * LA_THREADS / K1;
  if (CH > EL) CH = EL;
  if (CH < 1) CH = 1;
  if (K1 > LA_PF * LA_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)acc_len * sizeof(T) + (size_t)CH * per_elem +
                      (2 * (size_t)rows_max + 1) * sizeof(int);
  cudaError_t rc = cudaFuncSetAttribute(
      leaf_assemble_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return (int)rc;
  dim3 grid((unsigned)N, (unsigned)R);
  leaf_assemble_kernel<T><<<grid, LA_THREADS, smem, st>>>(
      u, epos, rhs_elem, dv, rv, EL, K, F1, R, CH, acc_len, rows_max, front);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_extend_add(const T* upd, long s_node, long s_child, long s_row,
                      const int* ext, const T* dv, const T* rv, int N, int F1,
                      T* front, cudaStream_t st) {
  if (N == 0) return 0;
  dim3 grid((unsigned)tile_count(F1, 0, F1, EA_TILE), (unsigned)N);
  extend_add_kernel<T><<<grid, EA_THREADS, 0, st>>>(
      upd, s_node, s_child, (int)s_row, ext, dv, rv, F1, front);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_syrk_update(T* front, int N, int F1, int r0, int c1, int k0, int k1,
                       cudaStream_t st) {
  if (F1 - r0 < SY_SMALL) {
    dim3 grid(tile_count(F1, r0, c1, 64), N);
    syrk_update_kernel<T, 64><<<grid, SY_THREADS, 0, st>>>(front, F1, r0, c1,
                                                           k0, k1);
  } else {
    dim3 grid(tile_count(F1, r0, c1, 128), N);
    syrk_update_kernel<T, 128><<<grid, SY_THREADS, 0, st>>>(front, F1, r0, c1,
                                                            k0, k1);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_front_factor(T* front, int N, int F1, int P, cudaStream_t st) {
  if (N == 0) return 0;
  int rc;
  for (int o0 = 0; o0 < P; o0 += OW) {
    const int o1 = P - o0 < OW ? P : o0 + OW;
    // the outer panel's columns [o0, o1): 32-wide inner panels that update
    // nothing to the right of o1
    for (int k0 = o0; k0 < o1; k0 += NB) {
      const int kb = o1 - k0 < NB ? o1 - k0 : NB;
      panel_diag_kernel<T><<<N, 32, 0, st>>>(front, F1, k0, kb);
      rc = (int)cudaGetLastError();
      if (rc) return rc;
      const int r0 = k0 + kb;              // r0 <= P < F1
      dim3 gt((F1 - r0 + TRSM_ROWS - 1) / TRSM_ROWS, N);
      panel_trsm_kernel<T><<<gt, TRSM_ROWS, 0, st>>>(front, F1, k0, kb);
      rc = (int)cudaGetLastError();
      if (rc) return rc;
      if (r0 == o1) continue;
      dim3 gu(tile_count(F1, r0, o1, TS), N);
      panel_update_kernel<T><<<gu, UPD_THREADS, 0, st>>>(front, F1, k0, kb,
                                                         o1);
      rc = (int)cudaGetLastError();
      if (rc) return rc;
    }
    // the remaining pivot columns [o1, P), rows >= o1, with depth o1 - o0
    if (o1 < P) {
      rc = launch_syrk_update(front, N, F1, o1, P, o0, o1, st);
      if (rc) return rc;
    }
  }
  // the Schur block [P:, P:], once, with depth P
  return launch_syrk_update(front, N, F1, P, F1, 0, P, st);
}

// an H9 product (see h9_gemm_kernel) over N fronts of F1 x F1; offsets
// within a front.  Splits k while the tiles alone leave the card short of
// GM_FILL blocks, each split at least GM_SPLIT_DEPTH deep, and the partial
// sums fit ``work``.
template <typename T, bool SYM>
int h9_gemm(T* front, int N, long FF, long a_off, long a_sx, long a_sk,
            long b_off, long b_sx, long b_sk, T* c, long c_n, long c_rs,
            long c_cs, int M, int Nn, int K, T alpha, int beta, T* work,
            long work_len, cudaStream_t st) {
  if (M <= 0 || Nn <= 0 || K <= 0) return 0;
  // 128-tiles on wide outputs, unless their rows would waste more than
  // 64-tiles' on a short one
  const bool big = Nn >= 192 &&
                   (M >= 192 || (M + 127) / 128 * 128 == (M + 63) / 64 * 64);
  const int BT = big ? 128 : 64, KS = big ? 8 : 16;
  const int tiles_n = (Nn + BT - 1) / BT;
  const long tiles = (long)((M + BT - 1) / BT) * tiles_n;
  int nsplit = 1;
  while (tiles * N * nsplit < GM_FILL && K / (2 * nsplit) >= GM_SPLIT_DEPTH &&
         2L * nsplit * N * M * Nn <= work_len)
    nsplit *= 2;
  int kchunk = (K + nsplit - 1) / nsplit;
  kchunk = (kchunk + KS - 1) / KS * KS;
  nsplit = (K + kchunk - 1) / kchunk;
  dim3 grid((unsigned)tiles, (unsigned)nsplit, (unsigned)N);
  const T* a = front + a_off;
  const T* b = front + b_off;
  if (big)
    h9_gemm_kernel<T, 128, SYM><<<grid, GM_THREADS, 0, st>>>(
        a, FF, a_sx, a_sk, b, FF, b_sx, b_sk, c, c_n, c_rs, c_cs, M, Nn, K,
        kchunk, tiles_n, alpha, beta, work);
  else
    h9_gemm_kernel<T, 64, SYM><<<grid, GM_THREADS, 0, st>>>(
        a, FF, a_sx, a_sk, b, FF, b_sx, b_sk, c, c_n, c_rs, c_cs, M, Nn, K,
        kchunk, tiles_n, alpha, beta, work);
  int rc = (int)cudaGetLastError();
  if (rc || nsplit == 1) return rc;
  dim3 gr((unsigned)(((long)M * Nn + 255) / 256), (unsigned)N);
  h9_reduce_kernel<T><<<gr, 256, 0, st>>>(work, nsplit, M, Nn, c, c_n, c_rs,
                                          c_cs, alpha, beta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_front_factor_bwd(T* front, int N, int F1, int P, const T* gl,
                            const T* gq, T* gdiag, T* sbuf, T* work,
                            long work_len, cudaStream_t st) {
  if (N == 0 || P == 0) return 0;
  const long FF = (long)F1 * F1;
  const int B1 = F1 - P;
  int rc;
  h9_seed_kernel<T><<<dim3((P + H9_THREADS / 32 - 1) / (H9_THREADS / 32), N),
                      H9_THREADS, 0, st>>>(front, F1, P, gl, gq, gdiag);
  if ((rc = (int)cudaGetLastError())) return rc;
  // the Schur product's reverse: G[:P, P:] -= 2 L_bp^T dupd_s (rows c of
  // G; L_bp^T's (c, b) at [P + b][c], dupd_s's lower triangle at [P:, P:])
  rc = h9_gemm<T, true>(front, N, FF, (long)P * F1, 1, F1, (long)P * F1 + P,
                        1, F1, front + P, FF, F1, 1, P, B1, B1, T(-2), 1,
                        work, work_len, st);
  if (rc) return rc;
  const size_t smem = H9_BW * (H9_BW + 1) * sizeof(T);
  if ((rc = (int)cudaFuncSetAttribute(
           h9_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)))
    return rc;
  for (int j = (P - 1) / H9_BW * H9_BW; j >= 0; j -= H9_BW) {
    const int k = P - j < H9_BW ? P : j + H9_BW, kb = k - j;
    dim3 gt((F1 - k + H9_TRSM_ROWS - 1) / H9_TRSM_ROWS, N);
    h9_trsm_kernel<T><<<gt, H9_TRSM_ROWS, 0, st>>>(front, F1, j, kb);
    if ((rc = (int)cudaGetLastError())) return rc;
    // S = Xbar^T C: (l, i) of G[j + l][k + i], (i, l') of L[k + i][j + l'];
    // S[l][l'] at sbuf[l' H9_BW + l], for the diagonal kernel's loads
    rc = h9_gemm<T, false>(front, N, FF, (long)j * F1 + k, F1, 1,
                           (long)k * F1 + j, 1, F1, sbuf,
                           (long)H9_BW * H9_BW, 1, H9_BW, kb, kb, F1 - k,
                           T(1), 0, work, work_len, st);
    if (rc) return rc;
    h9_diag_kernel<T><<<N, H9_BW, smem, st>>>(front, F1, P, j, kb, gdiag,
                                              sbuf);
    if ((rc = (int)cudaGetLastError())) return rc;
    if (j > 0) {
      // Rbar: G[c][j + l] -= sum_i L[j + i][c] M[j + l][j + i], M = the
      // block's rows [j, k) from column j: Esym, then Xbar^T
      rc = h9_gemm<T, false>(front, N, FF, (long)j * F1, 1, F1,
                             (long)j * F1 + j, F1, 1, front + j, FF, F1, 1,
                             j, kb, F1 - j, T(-1), 1, work, work_len, st);
      if (rc) return rc;
      // Bbar: G[c][k + i] -= sum_l L[j + l][c] G[j + l][k + i]
      rc = h9_gemm<T, false>(front, N, FF, (long)j * F1, 1, F1,
                             (long)j * F1 + k, 1, F1, front + k, FF, F1, 1,
                             j, F1 - k, kb, T(-1), 1, work, work_len, st);
      if (rc) return rc;
    }
    dim3 gf(1 + (F1 - k + H9_BW - 1) / H9_BW, N);
    h9_final_kernel<T><<<gf, H9_THREADS, 0, st>>>(front, F1, j, kb);
    if ((rc = (int)cudaGetLastError())) return rc;
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

int gpv_front_factor_bwd_f32(float* front, int N, int F1, int P,
                              const float* gl, const float* gq, float* gdiag,
                              float* sbuf, float* work, long long work_len,
                              void* stream) {
  return launch_front_factor_bwd<float>(front, N, F1, P, gl, gq, gdiag, sbuf,
                                        work, work_len, (cudaStream_t)stream);
}

int gpv_front_factor_bwd_f64(double* front, int N, int F1, int P,
                              const double* gl, const double* gq,
                              double* gdiag, double* sbuf, double* work,
                              long long work_len, void* stream) {
  return launch_front_factor_bwd<double>(front, N, F1, P, gl, gq, gdiag,
                                         sbuf, work, work_len,
                                         (cudaStream_t)stream);
}

int gpv_extend_add_bwd_f32(const float* dfront, int N, int F1, const int* inv,
                           int Bc1, float* out, long long s_node,
                           long long s_child, long long s_row, float* ddv,
                           float* drv, void* stream) {
  return launch_extend_add_bwd<float>(dfront, N, F1, inv, Bc1, out, s_node,
                                      s_child, s_row, ddv, drv,
                                      (cudaStream_t)stream);
}

int gpv_extend_add_bwd_f64(const double* dfront, int N, int F1,
                           const int* inv, int Bc1, double* out,
                           long long s_node, long long s_child,
                           long long s_row, double* ddv, double* drv,
                           void* stream) {
  return launch_extend_add_bwd<double>(dfront, N, F1, inv, Bc1, out, s_node,
                                       s_child, s_row, ddv, drv,
                                       (cudaStream_t)stream);
}

int gpv_leaf_assemble_bwd_f32(const float* dfront, const float* u,
                              const int* epos, const float* rhs_elem, int N,
                              int EL, int K, int F1, float* du, float* dre,
                              float* ddv, float* drv, void* stream) {
  return launch_leaf_assemble_bwd<float>(dfront, u, epos, rhs_elem, N, EL, K,
                                         F1, du, dre, ddv, drv,
                                         (cudaStream_t)stream);
}

int gpv_leaf_assemble_bwd_f64(const double* dfront, const double* u,
                              const int* epos, const double* rhs_elem, int N,
                              int EL, int K, int F1, double* du, double* dre,
                              double* ddv, double* drv, void* stream) {
  return launch_leaf_assemble_bwd<double>(dfront, u, epos, rhs_elem, N, EL, K,
                                          F1, du, dre, ddv, drv,
                                          (cudaStream_t)stream);
}

}  // extern "C"
