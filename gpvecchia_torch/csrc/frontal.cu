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
// its columns are rows, contiguous.  The sweep runs in two levels, as H4's
// forward: outer panels of H9_OW columns from the last, and inside one,
// column blocks of H9_BW from the last.  A block's steps: T = Cbar^T C (a
// product of depth F1 - k into an (N, 64, 64) buffer, from the panel's
// cotangent before its solve); the reverse of the 64 x 64 diagonal block
// in closed form, one block of 256 threads a front, every step a product
// of 64 x 64 blocks in shared memory but D's inverse (a column a thread),
// with S = Xbar^T C = Dinv^T T; the panel solve Xbar^T = Dinv^T Cbar^T as a
// product in place (depth 64); then the panel products Rbar -= [Esym;
// Xbar]^T [R; B] and Bbar -= Xbar R on the panel's own cotangent rows only.
// Once the panel's blocks are done its rows of G are final, and its
// contributions to the rows left of it are two products of depth F1 - J
// and OW (not one pair of depth-64 updates of all of G[:j, k:] a block),
// reading the panel's rows of the upper triangle, diagonal blocks
// included, as one symmetric operand.  Then the panel's cotangent goes to
// the lower triangle, where L's columns [J, K) are dead.  Every product is
// one register-tiled SIMT kernel (64 x 64 or 128 x 128 outputs a block, 4
// x 4 or 8 x 8 a thread) whose k slabs come through a ring of four
// shared-memory slabs by asynchronous copies (cp.async, one value each:
// F1 is odd at most levels, so a front's rows start at any address, and
// 16-byte copies or TMA would need aligned rows), one barrier a slab, as
// H4's symmetric update.  It reads its operands through strides (the
// symmetric ones through one triangle) and splits a deep product over
// blocks when the output is too small to fill the card; the partial sums
// are added in a fixed order, so there are no atomics and two runs give the
// same bits.  What is left: the products run SIMT in float32 (no tensor
// cores; the Schur product's reverse at about 55 % of the SIMT peak on an
// NVIDIA H100 80GB HBM3 at 700 W), the leaf's short products are bound by
// latency, and the root's 55 blocks are a chain of about 400 launches.
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
// and multiplies by dfront (2e11 FLOP at n=1e6, m=40); here it is what it
// computes, (K+1)^2 gathers an element (1.8e9 at n=1e6, m=40), the
// transpose of H2: scattered 4-byte reads of device memory would each move
// a 32-byte sector, so the front's lower triangle is read once, coalesced,
// into shared memory (whole at the leaf in float32, 218 KB, else in row
// bands), and the gathers go there, those above the diagonal to the
// mirror.  Its least time is set by bytes (the lower triangles once, u in
// and du out).  What is left (NVIDIA H100 80GB HBM3, 700 W; n=1e6, m=40):
// 1.80 ms in float32 against 0.69: the gathers are random 4-byte reads of
// shared memory (bank conflicts), and with one block a front, whose
// triangle fills the SM's shared memory, a front's copy and its gathers do
// not overlap; float64 takes two bands, which walk every pair twice.  The
// diagonal adds' and the RHS vector's cotangents are read from the staged
// rows.
//
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
constexpr int H9_OW = 128;       // H9: outer panel (a multiple of H9_BW)
constexpr int H9_LD = H9_BW + 4; // its rows in shared memory: 16-byte aligned
constexpr int H9_THREADS = 256;  // H9's seed and final kernels
constexpr int H9_DIAG_THREADS = 256;  // H9's diagonal block: 16 x 16 threads
constexpr int GM_THREADS = 256;  // H9's products: 16 x 16 threads
constexpr int GM_KS = 16;        // their slab depth
constexpr int GM_STAGES = 4;     // their slabs in flight
constexpr int GM_SPLIT_DEPTH = 128;  // least depth a split of a product gets
constexpr int GM_FILL = 4 * 132;     // blocks below which a product splits:
                                     // four 64-tiles an SM
// blocks an SM should hold: the float32 128-tile at 128 registers a thread
#define GM_BLOCKS(T, BT) \
  ((BT) == 128 ? (sizeof(T) == 4 ? 2 : 1) : (sizeof(T) == 4 ? 4 : 2))
static_assert(H9_OW % H9_BW == 0, "whole column blocks per outer panel");
constexpr int LB_THREADS = 512;   // H7: a block a front
constexpr int LB_WARPS = LB_THREADS / 32;
constexpr int LB_CHUNK = 64;     // elements a chunk at most
constexpr int LB_PF = 4;         // a thread's slots of a chunk at most
constexpr int LB_G = 4;          // slots of one element a thread sums
constexpr int LB_PAD = -(1 << 30);  // a pad slot's row start

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

// seed, after the Schur product's reverse has written G[:P, P:]: rows c < P
// of the upper triangle hold G = Abar^T; Abar starts as Lbar: 0 but for
// 2 g_quad y in row F1-1 (G's column F1-1), and its diagonal 2 g_logdet /
// L_cc in gdiag.  One warp a row.
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
  for (int col = c + 1 + lane; col < P; col += 32) row[col] = T(0);
  if (lane == 0) {
    row[F1 - 1] += T(2) * gq[0] * A[(long)(F1 - 1) * F1 + c];
    gdiag[(long)blockIdx.y * P + c] = T(2) * gl[0] / row[c];
  }
}

// Thread t's u-th copy of a BT x GM_KS slab, e = t + GM_THREADS u, is the
// element (xx, kk): along k a warp copies 4 rows x 8 consecutive k (their
// shared-memory stores, rows padded by 4, fall into 32 distinct banks),
// along x 32 consecutive x.  Either way u moves a thread by a fixed step:
// 16 rows along k, GM_THREADS / BT values of k along x.
template <int BT>
__device__ __forceinline__ void gm_elem(int e, bool kfast, int& xx, int& kk) {
  if (kfast) {
    const int rest = e >> 5;
    xx = 4 * (rest / (GM_KS / 8)) + ((e >> 3) & 3);
    kk = 8 * (rest % (GM_KS / 8)) + (e & 7);
  } else {
    xx = e % BT;
    kk = e / BT;
  }
}

// asynchronous copies of the elements (x, k) of a BT x GM_KS slab at
// p[x ax + k ak] into sm[k][x] (rows of BT + 4), 0 past xlim and klim: all
// of them (sel < 0), those with k >= x (sel 0) or those with k < x (sel 1).
// Along k where k is contiguous (ak = 1), else along x, each thread from
// one address and a fixed step.
template <typename T, int BT>
__device__ __forceinline__ void gm_part(unsigned base, const T* p, long ax,
                                        long ak, int x0, int xlim, int k0,
                                        int klim, int sel) {
  constexpr int R = BT * GM_KS / GM_THREADS;
  constexpr int XU = 4 * (GM_THREADS / 32) / (GM_KS / 8);  // x step along k
  constexpr int KU = GM_THREADS / BT;                       // k step along x
  static_assert(GM_THREADS % BT == 0 && R * GM_THREADS == BT * GM_KS,
                "slab shape");
  int xx, kk;
  gm_elem<BT>(threadIdx.x, ak == 1, xx, kk);
  const T* src = p + (x0 + xx) * ax + (k0 + kk) * ak;
  const unsigned dst = base + (unsigned)((kk * (BT + 4) + xx) * sizeof(T));
  const int x = x0 + xx, k = k0 + kk;
  if (ak == 1) {
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (sel < 0 || (k < x + u * XU) == (sel == 1))
        cp_async_or_zero(dst + (unsigned)(u * XU * sizeof(T)),
                         src + u * XU * ax, k < klim && x + u * XU < xlim);
  } else {
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (sel < 0 || (k + u * KU < x) == (sel == 1))
        cp_async_or_zero(dst + (unsigned)(u * KU * (BT + 4) * sizeof(T)),
                         src + u * KU * ak, x < xlim && k + u * KU < klim);
  }
}

// asynchronous copies of a BT x GM_KS slab of an operand whose element
// (x, k) is p[x sx + k sk] (SYM: p[k sx + x sk] where k < x, the mirror of
// the lower triangle) into sm[k][x]; 0 past xlim and klim.  A slab that
// straddles a symmetric operand's diagonal is copied in two parts, each
// along its own contiguous index.
template <typename T, int BT, bool SYM>
__device__ __forceinline__ void gm_stage(T* sm, const T* p, long sx, long sk,
                                         int x0, int xlim, int k0, int klim) {
  const unsigned base = smem_addr(sm);
  const bool mirror = SYM && k0 + GM_KS <= x0;   // wholly above: all k < x
  if (SYM && !mirror && k0 < x0 + BT - 1) {
    gm_part<T, BT>(base, p, sx, sk, x0, xlim, k0, klim, 0);
    gm_part<T, BT>(base, p, sk, sx, x0, xlim, k0, klim, 1);
  } else if (mirror) {
    gm_part<T, BT>(base, p, sk, sx, x0, xlim, k0, klim, -1);
  } else {
    gm_part<T, BT>(base, p, sx, sk, x0, xlim, k0, klim, -1);
  }
}

// bytes of shared memory an H9 product block of BT takes
template <typename T>
constexpr int gm_smem_bytes(int BT) {
  return 2 * GM_STAGES * GM_KS * (BT + 4) * (int)sizeof(T);
}

// H9's products: C = (beta ? C : 0) + alpha A B over N fronts, A (M x K)
// with element (m, k) at a[n a_n + m a_sx + k a_sk], B (K x Nn) with
// element (k, x) at b[n b_n + x b_sx + k b_sk] (SYM: B symmetric, read
// through the triangle k >= x), C (M x Nn) at c[n c_n + m c_rs + x c_cs].
// The operands and C may lie in the same fronts (disjoint regions, or C
// over B when one block reads all of B that its tile needs: the panel
// solve), so nothing is __restrict__.  One BT x BT tile of C a block
// (grid: tiles x splits x fronts), 16 x 16 threads of TMS x TMS outputs in
// groups of 4 consecutive rows and columns (16-byte shared loads).  k runs
// in slabs of GM_KS, staged transposed in shared memory in a ring of
// GM_STAGES: asynchronous copies (cp.async, one value each, since a front's
// rows start at any address) bring slab s + GM_STAGES - 1 in while slab s
// is multiplied, one barrier a slab.  With splits, block (tile, s) sums k in
// [s kchunk, (s + 1) kchunk) into work[n][s] (M x Nn), which
// h9_reduce_kernel adds in order of s.
template <typename T, int BT, bool SYM>
__global__ void __launch_bounds__(GM_THREADS, GM_BLOCKS(T, BT))
h9_gemm_kernel(const T* a, long a_n, long a_sx, long a_sk, const T* b,
               long b_n, long b_sx, long b_sk, T* c, long c_n, long c_rs,
               long c_cs, int M, int Nn, int K, int kchunk, int tiles_n,
               T alpha, int beta, T* work) {
  constexpr int S = BT + 4;
  constexpr int SLAB = GM_KS * S;
  constexpr int TMS = BT / 16, G = TMS / 4, GS = BT / G;
  static_assert(BT * GM_KS % GM_THREADS == 0 && TMS % 4 == 0 &&
                GM_KS % 8 == 0, "slab shape");
  extern __shared__ __align__(16) unsigned char gm_smem[];
  T* As = reinterpret_cast<T*>(gm_smem);     // GM_STAGES slabs of A, of B
  T* Bs = As + GM_STAGES * SLAB;
  const long n = blockIdx.z;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x - tm * tiles_n;
  const int m0 = tm * BT, n0 = tn * BT;
  const int kb0 = split * kchunk, kb1 = min(K, kb0 + kchunk);
  const int ns = (kb1 - kb0 + GM_KS - 1) / GM_KS;
  const T* pa = a + n * a_n;
  const T* pb = b + n * b_n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // slab s into its ring slot; a group is committed in any case, so that
  // the count of groups in flight is the same in every iteration
  auto stage = [&](int s) {
    if (s < ns) {
      const int kb = kb0 + s * GM_KS, slot = s % GM_STAGES;
      gm_stage<T, BT, false>(As + slot * SLAB, pa, a_sx, a_sk, m0, M, kb,
                             kb1);
      gm_stage<T, BT, SYM>(Bs + slot * SLAB, pb, b_sx, b_sk, n0, Nn, kb,
                           kb1);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  T acc[TMS][TMS];
#pragma unroll
  for (int p = 0; p < TMS; ++p)
#pragma unroll
    for (int q = 0; q < TMS; ++q) acc[p][q] = T(0);
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) stage(s);
  for (int s = 0; s < ns; ++s) {
    // slab s has landed; the barrier also frees the slot of slab s - 1,
    // which every thread has finished multiplying
    asm volatile("cp.async.wait_group %0;\n" :: "n"(GM_STAGES - 2)
                 : "memory");
    __syncthreads();
    stage(s + GM_STAGES - 1);
    const T* as = As + (s % GM_STAGES) * SLAB;
    const T* bs = Bs + (s % GM_STAGES) * SLAB;
#pragma unroll
    for (int k = 0; k < GM_KS; ++k) {
      T av[TMS], bv[TMS];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ld4(as + k * S + g * GS + 4 * ty, av + 4 * g);
        ld4(bs + k * S + g * GS + 4 * tx, bv + 4 * g);
      }
#pragma unroll
      for (int p = 0; p < TMS; ++p)
#pragma unroll
        for (int q = 0; q < TMS; ++q) acc[p][q] += av[p] * bv[q];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Out[a][b] = sum_i L[i][a] R[i][b] over i in [lo, hi) for the diagonal
// kernel's 64 x 64 blocks in shared memory: 16 x 16 threads of 4 x 4
// outputs, rows 4 ty + p and columns 4 tx + q (16-byte loads).  Every
// product there has L upper triangular in (i, a) (an inverse or a factor,
// read as its transpose) and no term past kb: i runs from 4 ty, which is
// the same in a half warp, to kb.
template <typename T>
__device__ __forceinline__ void h9_mm(T (&acc)[4][4], const T (*L)[H9_LD],
                                      const T (*R)[H9_LD], int kb) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);
#pragma unroll 4
  for (int i = 4 * ty; i < kb; ++i) {
    T a[4], b[4];
    ld4(&L[i][4 * ty], a);
    ld4(&R[i][4 * tx], b);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] += a[p] * b[q];
  }
}

// The reverse of the block's diagonal factor D = chol(E) in closed form,
// one block of H9_DIAG_THREADS a front, every step a product of 64 x 64
// blocks in shared memory (``h9_mm``) but the inverse: Dinv = D^{-1}, a
// column a thread of the first 64 (the identity past kb; written to dbuf
// for the panel solve); S = Xbar^T C = Dinv^T T with T = Cbar^T C (tbuf,
// the product of the panel's cotangent before its solve); Dbar = Abar's
// block (G's upper triangle of the block, transposed, and gdiag) minus
// tril(S); M = D^T Dbar, Phi = tril(M) with its diagonal halved, Sym = Phi
// + Phi^T, and Esym = Dinv^T Sym Dinv (the JAX package's `_chol_vjp`,
// whose 1/4 (dA + dA^T) is 1/2 Esym), as X = Dinv^T Sym, then its
// transpose E^T = Dinv^T X^T.  Writes Esym, symmetrized, into both
// triangles of the block (D is dead).
template <typename T>
__global__ void __launch_bounds__(H9_DIAG_THREADS)
h9_diag_kernel(T* __restrict__ front, int F1, int P, int j, int kb,
               const T* __restrict__ gdiag, const T* __restrict__ tbuf,
               T* __restrict__ dbuf) {
  extern __shared__ __align__(16) unsigned char h9_smem[];
  T (*B0)[H9_LD] = reinterpret_cast<T (*)[H9_LD]>(h9_smem);
  T (*B1)[H9_LD] = B0 + H9_BW;
  T (*B2)[H9_LD] = B1 + H9_BW;
  T (*B3)[H9_LD] = B2 + H9_BW;
  const long n = blockIdx.x;
  T* A = front + n * F1 * F1;
  const T* Tn = tbuf + n * H9_BW * H9_BW;
  T* Dn = dbuf + n * H9_BW * H9_BW;
  const T* gd = gdiag + n * P + j;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  // B0 = D, B1 = D^T, B2 = T, B3 = Dbar but for S (zero past kb; its
  // strict lower triangle from G's rows j + r, read along them), rd = 1 / D's
  // diagonal; unrolled, so that a thread's loads are in flight together
  // (at the top levels a launch is one or a few fronts: latency)
  __shared__ T rd[H9_BW];
#pragma unroll 8
  for (int q = t; q < H9_BW * H9_BW; q += H9_DIAG_THREADS) {
    const int r = q / H9_BW, s = q - (q / H9_BW) * H9_BW;
    T d = r == s ? T(1) : T(0);
    if (r < kb && s <= r) d = A[(long)(j + r) * F1 + j + s];
    B0[r][s] = d;
    B1[s][r] = d;
    if (r == s) rd[r] = T(1) / d;
    B2[r][s] = (r < kb && s < kb) ? Tn[r * H9_BW + s] : T(0);
    T e = T(0);
    if (s < kb && r < s) e = A[(long)(j + r) * F1 + j + s];
    else if (s < kb && r == s) e = gd[s];
    B3[s][r] = e;
  }
  __syncthreads();
  // Dinv's column t: forward substitution, each solved value's share
  // taken from the rows below at once (independent updates; D's column
  // read as a row of D^T, the same address in every thread)
  T y[H9_BW];
  if (t < H9_BW) {
#pragma unroll
    for (int i = 0; i < H9_BW; ++i) y[i] = i == t ? T(1) : T(0);
#pragma unroll
    for (int i = 0; i < H9_BW; ++i) {
      y[i] *= rd[i];
#pragma unroll
      for (int m4 = (i + 1) / 4 * 4; m4 < H9_BW; m4 += 4) {
        T d[4];
        ld4(&B1[i][m4], d);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (m4 + q > i) y[m4 + q] -= d[q] * y[i];
      }
    }
  }
  __syncthreads();
  if (t < H9_BW) {
#pragma unroll
    for (int i = 0; i < H9_BW; ++i) B1[i][t] = y[i];
  }
  __syncthreads();
  T acc[4][4];
  h9_mm(acc, B1, B2, kb);                      // S = Dinv^T T
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int a = 4 * ty + p, b = 4 * tx + q;
      B3[a][b] = b <= a ? B3[a][b] - acc[p][q] : T(0);
    }
  __syncthreads();
  h9_mm(acc, B0, B3, kb);                      // M = D^T Dbar
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) B2[4 * ty + p][4 * tx + q] = acc[p][q];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 4; ++p)                  // Sym
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int a = 4 * ty + p, b = 4 * tx + q;
      B0[a][b] = b <= a ? B2[a][b] : B2[b][a];
    }
  __syncthreads();
  h9_mm(acc, B1, B0, kb);                      // X = Dinv^T Sym, stored
#pragma unroll                                 // as Xt = Sym Dinv
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) B3[4 * tx + q][4 * ty + p] = acc[p][q];
  __syncthreads();
  h9_mm(acc, B1, B3, kb);                      // E^T = Dinv^T Xt
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) B2[4 * ty + p][4 * tx + q] = acc[p][q];
#pragma unroll 4
  for (int q = t; q < H9_BW * H9_BW; q += H9_DIAG_THREADS)
    Dn[q] = B1[q / H9_BW][q % H9_BW];
  __syncthreads();
#pragma unroll 4
  for (int q = t; q < kb * kb; q += H9_DIAG_THREADS) {
    const int l = q / kb, m = q - (q / kb) * kb;
    A[(long)(j + l) * F1 + j + m] = T(0.5) * (B2[l][m] + B2[m][l]);
  }
}

// A finished outer panel's cotangent into the lower triangle, where L's
// columns [J, K) are dead: A[r][c] = 1/2 A[c][r] for c in [J, K) and r >= c
// (rows c of the upper triangle hold G, and the diagonal blocks Esym in
// both triangles).  A 64 x 64 tile a block (grid: row tiles from J x column
// tiles x fronts), transposed through shared memory; tiles wholly above
// the diagonal return.
template <typename T>
__global__ void __launch_bounds__(H9_THREADS)
h9_final_kernel(T* __restrict__ front, int F1, int J, int K) {
  __shared__ T tile[H9_BW][H9_BW + 1];
  T* A = front + (long)blockIdx.z * F1 * F1;
  const int r0 = J + blockIdx.x * H9_BW, c0 = J + blockIdx.y * H9_BW;
  if (r0 + H9_BW <= c0) return;
  for (int t = threadIdx.x; t < H9_BW * H9_BW; t += H9_THREADS) {
    const int cc = t / H9_BW, rr = t - (t / H9_BW) * H9_BW;
    const int c = c0 + cc, r = r0 + rr;
    if (c < K && r < F1 && r >= c) tile[cc][rr] = A[(long)c * F1 + r];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < H9_BW * H9_BW; t += H9_THREADS) {
    const int rr = t / H9_BW, cc = t - (t / H9_BW) * H9_BW;
    const int c = c0 + cc, r = r0 + rr;
    if (c < K && r < F1 && r >= c)
      A[(long)r * F1 + c] = T(0.5) * tile[cc][rr];
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

// One block a front: the lower triangle of dfront in R row bands (one where
// it fits beside a chunk, as at the leaf in float32), each staged once in
// shared memory (packed rows, asynchronous copies along the rows); the
// diagonal adds' and the RHS vector's cotangents are read from the staged
// rows.  The elements come in chunks of CH, a thread's slots of the next
// chunk loaded into registers while the block works on the current one;
// a slot is staged as its position p, tri(p) = p (p + 1) / 2 less the
// band's start and its value (a pad as position 0 and value 0).  A slot
// sums over the element's slots l in order (the RHS weight last, at F1-1)
// the staged entries
// dfront[max(p_k, p_l)][min(p_k, p_l)] whose row lies in the band, at
// max(tri(p_k) + p_l, tri(p_l) + p_k): an entry above the diagonal is read
// at its mirror in shared memory.  The loop over l has no branch, so that
// its loads overlap; a thread takes LB_G slots of one element, which share
// each partner's loads (4 bytes of a random row each: the gathers are
// bound by shared-memory bank conflicts).  With several bands each band walks every pair
// again, and a slot's sums are added band by band into du and dre (the same
// thread each time): a fixed order, no atomics.
template <typename T>
__global__ void __launch_bounds__(LB_THREADS)
leaf_assemble_bwd_kernel(const T* __restrict__ dfront,
                         const T* __restrict__ u,
                         const int* __restrict__ epos,
                         const T* __restrict__ rhs_elem, int EL, int K,
                         int F1, int R, int CH, int acc_len,
                         T* __restrict__ du, T* __restrict__ dre,
                         T* __restrict__ ddv, T* __restrict__ drv) {
  extern __shared__ __align__(16) unsigned char lb_smem[];
  const int K1 = K + 1;
  T* band = reinterpret_cast<T*>(lb_smem);         // the band, packed rows
  int2* pt = reinterpret_cast<int2*>(band + acc_len);  // the chunk's CH x K1
  T* val = reinterpret_cast<T*>(pt + CH * K1);     // slots: (p, tri(p)), u
  const long n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Dn = dfront + n * F1 * F1;
  const T* un = u + n * EL * K;
  const int* pn = epos + n * EL * K;
  const T* rn = rhs_elem + n * EL;
  // slot t of a chunk is (element, slot) = (t / K1, t % K1); the quotient
  // by a multiply-high, exact for t K1 < 2^32
  const unsigned magic = (unsigned)((0x100000000ull + K1 - 1) / K1);
  int pr[LB_PF];
  T vr[LB_PF];
  auto load_chunk = [&](int e0) {   // this thread's slots into registers
    const int S = (EL - e0 < CH ? EL - e0 : CH) * K1;
#pragma unroll
    for (int q = 0; q < LB_PF; ++q) {
      const int t = tid + LB_THREADS * q;
      pr[q] = -1;
      vr[q] = T(0);
      if (t < S) {
        const int e = __umulhi((unsigned)t, magic), k = t - e * K1;
        if (k < K) {
          pr[q] = pn[(long)(e0 + e) * K + k];
          vr[q] = un[(long)(e0 + e) * K + k];
        } else {
          pr[q] = F1 - 1;
          vr[q] = rn[e0 + e];
        }
      }
    }
  };
  const unsigned sband = smem_addr(band);
  for (int b = 0; b < R; ++b) {
    const int r0 = band_start(b, R, F1), r1 = band_start(b + 1, R, F1);
    const int base = r0 * (r0 + 1) / 2;
    if (EL > 0) load_chunk(0);
    __syncthreads();                    // the previous band is consumed
    for (int i = r0 + warp; i < r1; i += LB_WARPS) {
      const T* row = Dn + (long)i * F1;
      const unsigned o = sband + (unsigned)((i * (i + 1) / 2 - base) *
                                            sizeof(T));
      for (int j = lane; j <= i; j += 32)
        cp_async_or_zero(o + (unsigned)(j * sizeof(T)), row + j, true);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int i = r0 + tid; i < r1; i += LB_THREADS)
      ddv[n * F1 + i] = band[i * (i + 1) / 2 + i - base];
    if (r1 == F1) {                     // row F1-1: the RHS vector's
      const T* last = band + (F1 - 1) * F1 / 2 - base;
      for (int f = tid; f < F1; f += LB_THREADS)
        drv[n * F1 + f] = last[f] + last[f];
    }
    for (int e0 = 0; e0 < EL; e0 += CH) {
      const int S = (EL - e0 < CH ? EL - e0 : CH) * K1;
      if (e0 > 0) __syncthreads();      // the previous chunk is consumed
#pragma unroll
      for (int q = 0; q < LB_PF; ++q) {
        const int t = tid + LB_THREADS * q;
        if (t < S) {
          const bool real = pr[q] >= 0;
          pt[t] = make_int2(real ? pr[q] : 0,
                            real ? pr[q] * (pr[q] + 1) / 2 - base : LB_PAD);
          val[t] = real ? vr[q] : T(0);
        }
      }
      if (e0 + CH < EL) load_chunk(e0 + CH);
      __syncthreads();
      // thread t: slots [G q, G q + G) of element e (t = e TPE + q), which
      // share each partner's loads
      const int TPE = (K1 + LB_G - 1) / LB_G;
      for (int t = tid; t < S / K1 * TPE; t += LB_THREADS) {
        const int e = t / TPE, k0 = (t - e * TPE) * LB_G;
        const int2* pe = pt + e * K1;
        const T* ve = val + e * K1;
        int pk[LB_G], tk[LB_G];
        bool real[LB_G];
#pragma unroll
        for (int i = 0; i < LB_G; ++i) {
          const int2 m = k0 + i < K1 ? pe[k0 + i] : make_int2(0, LB_PAD);
          real[i] = m.y != LB_PAD;       // a pad sums at row 0, writes 0
          pk[i] = real[i] ? m.x : 0;
          tk[i] = real[i] ? m.y : 0;
        }
        T acc[LB_G];
#pragma unroll
        for (int i = 0; i < LB_G; ++i) acc[i] = T(0);
        if (R == 1) {
#pragma unroll 2
          for (int l = 0; l < K1; ++l) {
            const int2 o = pe[l];
            const T w = ve[l];
#pragma unroll
            for (int i = 0; i < LB_G; ++i)
              acc[i] += band[max(tk[i] + o.x, o.y + pk[i])] * w;
          }
        } else {
#pragma unroll 2
          for (int l = 0; l < K1; ++l) {
            const int2 o = pe[l];
            const T w = ve[l];
#pragma unroll
            for (int i = 0; i < LB_G; ++i) {
              const int hi = max(pk[i], o.x);
              T v = T(0);                // no load outside the band
              if (hi >= r0 && hi < r1) v = band[max(tk[i] + o.x, o.y + pk[i])];
              acc[i] += v * w;
            }
          }
        }
        const long g = n * EL + e0 + e;
#pragma unroll
        for (int i = 0; i < LB_G; ++i) {
          const int k = k0 + i;
          if (k >= K1) break;
          T out = real[i] ? acc[i] + acc[i] : T(0);
          if (k < K) {
            if (b > 0) out += du[g * K + k];
            du[g * K + k] = out;
          } else {
            if (b > 0) out += dre[g];
            dre[g] = out;
          }
        }
      }
    }
  }
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

// the longest of R bands' packed lengths and the most rows a band has
inline void band_extent(int F1, int R, int& acc_len, int& rows_max) {
  acc_len = rows_max = 0;
  for (int b = 0; b < R; ++b) {
    const int r0 = band_start(b, R, F1), r1 = band_start(b + 1, R, F1);
    const int len = r1 * (r1 + 1) / 2 - r0 * (r0 + 1) / 2;
    if (len > acc_len) acc_len = len;
    if (r1 - r0 > rows_max) rows_max = r1 - r0;
  }
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
  band_extent(F1, R, acc_len, rows_max);
  acc_len += acc_len & 1;          // keep the staged values 8-byte aligned
}

template <typename T>
int launch_leaf_assemble_bwd(const T* dfront, const T* u, const int* epos,
                             const T* rhs_elem, int N, int EL, int K, int F1,
                             T* du, T* dre, T* ddv, T* drv, cudaStream_t st) {
  if (N == 0) return 0;
  const int K1 = K + 1;
  if (K1 > LB_PF * LB_THREADS) return (int)cudaErrorInvalidValue;
  int dev, optin;
  cudaError_t rc = cudaGetDevice(&dev);
  if (!rc)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc) return (int)rc;
  // the fewest bands whose longest leaves room beside it for a chunk of 8
  // elements (or all of them), and the largest chunk that room takes
  const long long per_elem = (long long)K1 * (sizeof(T) + sizeof(int2));
  const long long need = (EL < 8 ? (EL > 0 ? EL : 1) : 8) * per_elem;
  int R = 1, acc_len, rows_max;
  long long left;
  for (;; ++R) {
    band_extent(F1, R, acc_len, rows_max);
    left = (long long)optin - (acc_len + 1) * (long long)sizeof(T);
    if (left >= need) break;
    if (R >= F1) return (int)cudaErrorInvalidValue;
  }
  long long CH = left / per_elem;
  if (CH > LB_CHUNK) CH = LB_CHUNK;
  if (CH * K1 > LB_PF * LB_THREADS) CH = LB_PF * LB_THREADS / K1;
  if (CH > EL) CH = EL;
  if (CH < 1) CH = 1;
  const size_t chunk = (size_t)(CH * per_elem);
  acc_len += acc_len & 1;          // keep the chunk's slots 8-byte aligned
  const size_t smem = (size_t)acc_len * sizeof(T) + chunk;
  rc = cudaFuncSetAttribute(leaf_assemble_bwd_kernel<T>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (rc) return (int)rc;
  leaf_assemble_bwd_kernel<T><<<N, LB_THREADS, smem, st>>>(
      dfront, u, epos, rhs_elem, EL, K, F1, R, (int)CH, acc_len, du, dre,
      ddv, drv);
  return (int)cudaGetLastError();
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

// the dynamic shared memory of H9's product and diagonal kernels
template <typename T>
int h9_setup() {
  const struct { const void* f; int bytes; } k[] = {
      {(const void*)h9_gemm_kernel<T, 64, false>, gm_smem_bytes<T>(64)},
      {(const void*)h9_gemm_kernel<T, 64, true>, gm_smem_bytes<T>(64)},
      {(const void*)h9_gemm_kernel<T, 128, false>, gm_smem_bytes<T>(128)},
      {(const void*)h9_gemm_kernel<T, 128, true>, gm_smem_bytes<T>(128)},
      {(const void*)h9_diag_kernel<T>,
       4 * H9_BW * H9_LD * (int)sizeof(T)}};
  for (const auto& e : k) {
    const cudaError_t rc = cudaFuncSetAttribute(
        e.f, cudaFuncAttributeMaxDynamicSharedMemorySize, e.bytes);
    if (rc) return (int)rc;
  }
  return 0;
}

// an H9 product (see h9_gemm_kernel) over N fronts; a_n, b_n and c_n step
// from one front's operand to the next's.  Splits k while the tiles alone
// leave the card short of GM_FILL blocks, each split at least
// GM_SPLIT_DEPTH deep, and the partial sums fit ``work``.  Adds its
// launches to ``*launches``.
template <typename T, bool SYM>
int h9_gemm(int N, const T* a, long a_n, long a_sx, long a_sk, const T* b,
            long b_n, long b_sx, long b_sk, T* c, long c_n, long c_rs,
            long c_cs, int M, int Nn, int K, T alpha, int beta, T* work,
            long work_len, int* launches, cudaStream_t st) {
  if (M <= 0 || Nn <= 0 || K <= 0) return 0;
  // 128-tiles on wide outputs, unless their rows would waste more than
  // 64-tiles' on a short one
  const bool big = Nn >= 192 &&
                   (M >= 192 || (M + 127) / 128 * 128 == (M + 63) / 64 * 64);
  const int BT = big ? 128 : 64;
  const int tiles_n = (Nn + BT - 1) / BT;
  const long tiles = (long)((M + BT - 1) / BT) * tiles_n;
  int nsplit = 1;
  while (tiles * N * nsplit < GM_FILL && K / (2 * nsplit) >= GM_SPLIT_DEPTH &&
         2L * nsplit * N * M * Nn <= work_len)
    nsplit *= 2;
  int kchunk = (K + nsplit - 1) / nsplit;
  kchunk = (kchunk + GM_KS - 1) / GM_KS * GM_KS;
  nsplit = (K + kchunk - 1) / kchunk;
  dim3 grid((unsigned)tiles, (unsigned)nsplit, (unsigned)N);
  if (big)
    h9_gemm_kernel<T, 128, SYM><<<grid, GM_THREADS, gm_smem_bytes<T>(128),
                                  st>>>(
        a, a_n, a_sx, a_sk, b, b_n, b_sx, b_sk, c, c_n, c_rs, c_cs, M, Nn, K,
        kchunk, tiles_n, alpha, beta, work);
  else
    h9_gemm_kernel<T, 64, SYM><<<grid, GM_THREADS, gm_smem_bytes<T>(64),
                                 st>>>(
        a, a_n, a_sx, a_sk, b, b_n, b_sx, b_sk, c, c_n, c_rs, c_cs, M, Nn, K,
        kchunk, tiles_n, alpha, beta, work);
  ++*launches;
  int rc = (int)cudaGetLastError();
  if (rc || nsplit == 1) return rc;
  dim3 gr((unsigned)(((long)M * Nn + 255) / 256), (unsigned)N);
  h9_reduce_kernel<T><<<gr, 256, 0, st>>>(work, nsplit, M, Nn, c, c_n, c_rs,
                                          c_cs, alpha, beta);
  ++*launches;
  return (int)cudaGetLastError();
}

// The schedule: the Schur product's reverse; seed; then outer panels [J, K)
// of H9_OW columns from the last, and in each, column blocks [j, k) of
// H9_BW from the last: T = Cbar^T C, the diagonal block's reverse (and
// Dinv), the panel solve Xbar^T = Dinv^T Cbar^T in place, and the block's
// Rbar and Bbar on the panel's own cotangent rows [J, j).  Once the panel's
// blocks are done, its rows of G are final, and its contributions to the
// rows c < J are two products of depth F1 - J and K - J: Rbar's, G[:J, J:K]
// -= (W L[J:, :J])^T with W[x][i] = A[J + min(x, i)][J + max(x, i)] (the
// panel's rows of the upper triangle, its diagonal blocks Esym, read as
// one symmetric operand: the columns inside [J, K) of both Rbar and Bbar),
// and Bbar's, G[:J, K:] -= L[J:K, :J]^T G[J:K, K:].  Then the panel's
// cotangent goes to the lower triangle.  L[:, :J] is read until then, and
// nothing before the panel's final kernel writes the lower triangle of
// columns [J, K).
template <typename T>
int launch_front_factor_bwd(T* front, int N, int F1, int P, const T* gl,
                            const T* gq, T* gdiag, T* tbuf, T* dbuf, T* work,
                            long work_len, int* launches, cudaStream_t st) {
  if (N == 0 || P == 0) return 0;
  const long FF = (long)F1 * F1, BB = (long)H9_BW * H9_BW;
  const int B1 = F1 - P;
  int rc;
  if ((rc = h9_setup<T>())) return rc;
  // the Schur product's reverse: G[:P, P:] = -2 L_bp^T dupd_s (rows c of
  // G; L_bp^T's (c, b) at [P + b][c], dupd_s's lower triangle at [P:, P:]),
  // then the seed adds Lbar's row F1-1
  rc = h9_gemm<T, true>(N, front + (long)P * F1, FF, 1, F1,
                        front + (long)P * F1 + P, FF, 1, F1, front + P, FF,
                        F1, 1, P, B1, B1, T(-2), 0, work, work_len, launches,
                        st);
  if (rc) return rc;
  h9_seed_kernel<T><<<dim3((P + H9_THREADS / 32 - 1) / (H9_THREADS / 32), N),
                      H9_THREADS, 0, st>>>(front, F1, P, gl, gq, gdiag);
  ++*launches;
  if ((rc = (int)cudaGetLastError())) return rc;
  const int dsmem = 4 * H9_BW * H9_LD * (int)sizeof(T);
  for (int J = (P - 1) / H9_OW * H9_OW; J >= 0; J -= H9_OW) {
    const int K = P - J < H9_OW ? P : J + H9_OW;
    for (int j = J + (K - 1 - J) / H9_BW * H9_BW; j >= J; j -= H9_BW) {
      const int k = K - j < H9_BW ? K : j + H9_BW, kb = k - j;
      T* Y = front + (long)j * F1 + k;      // Cbar^T: G[j + l][k + i]
      // T = Cbar^T C: (l, i) of G[j + l][k + i], (i, l') of L[k + i][j + l']
      rc = h9_gemm<T, false>(N, Y, FF, F1, 1, front + (long)k * F1 + j, FF,
                             1, F1, tbuf, BB, H9_BW, 1, kb, kb, F1 - k, T(1),
                             0, work, work_len, launches, st);
      if (rc) return rc;
      h9_diag_kernel<T><<<N, H9_DIAG_THREADS, dsmem, st>>>(
          front, F1, P, j, kb, gdiag, tbuf, dbuf);
      ++*launches;
      if ((rc = (int)cudaGetLastError())) return rc;
      // Xbar^T = Dinv^T Cbar^T, in place: depth kb, so no split, and a
      // block reads all of its columns of Y before it writes them
      rc = h9_gemm<T, false>(N, dbuf, BB, 1, H9_BW, Y, FF, 1, F1, Y, FF, F1,
                             1, kb, F1 - k, kb, T(1), 0, nullptr, 0,
                             launches, st);
      if (rc) return rc;
      if (j > J) {
        // Rbar, rows c in [J, j): G[c][j + l] -= sum_i L[j + i][c]
        // M[j + l][j + i], M = the block's rows [j, k) from column j: Esym,
        // then Xbar^T
        rc = h9_gemm<T, false>(N, front + (long)j * F1 + J, FF, 1, F1,
                               front + (long)j * F1 + j, FF, F1, 1,
                               front + (long)J * F1 + j, FF, F1, 1, j - J, kb,
                               F1 - j, T(-1), 1, work, work_len, launches,
                               st);
        if (rc) return rc;
        // Bbar, rows c in [J, j): G[c][k + i] -= sum_l L[j + l][c]
        // G[j + l][k + i]
        rc = h9_gemm<T, false>(N, front + (long)j * F1 + J, FF, 1, F1, Y, FF,
                               1, F1, front + (long)J * F1 + k, FF, F1, 1,
                               j - J, F1 - k, kb, T(-1), 1, work, work_len,
                               launches, st);
        if (rc) return rc;
      }
    }
    if (J > 0) {
      // the panel's Rbar on the rows c < J: G[c][J + x] -= sum_i
      // L[J + i][c] W[x][i], W read through the upper triangle of the
      // panel's rows (SYM, its triangle k >= x at [J + x][J + k])
      rc = h9_gemm<T, true>(N, front + (long)J * F1, FF, 1, F1,
                            front + (long)J * F1 + J, FF, F1, 1, front + J,
                            FF, F1, 1, J, K - J, F1 - J, T(-1), 1, work,
                            work_len, launches, st);
      if (rc) return rc;
      // the panel's Bbar on the rows c < J: G[c][K + x] -= sum_r
      // L[J + r][c] G[J + r][K + x]
      rc = h9_gemm<T, false>(N, front + (long)J * F1, FF, 1, F1,
                             front + (long)J * F1 + K, FF, 1, F1, front + K,
                             FF, F1, 1, J, F1 - K, K - J, T(-1), 1, work,
                             work_len, launches, st);
      if (rc) return rc;
    }
    dim3 gf((F1 - J + H9_BW - 1) / H9_BW, (K - J + H9_BW - 1) / H9_BW, N);
    h9_final_kernel<T><<<gf, H9_THREADS, 0, st>>>(front, F1, J, K);
    ++*launches;
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
                              float* tbuf, float* dbuf, float* work,
                              long long work_len, int* launches,
                              void* stream) {
  return launch_front_factor_bwd<float>(front, N, F1, P, gl, gq, gdiag, tbuf,
                                        dbuf, work, work_len, launches,
                                        (cudaStream_t)stream);
}

int gpv_front_factor_bwd_f64(double* front, int N, int F1, int P,
                              const double* gl, const double* gq,
                              double* gdiag, double* tbuf, double* dbuf,
                              double* work, long long work_len, int* launches,
                              void* stream) {
  return launch_front_factor_bwd<double>(front, N, F1, P, gl, gq, gdiag,
                                         tbuf, dbuf, work, work_len, launches,
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
