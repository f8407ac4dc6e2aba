// Device helpers shared by the two routes of H1 and H5
// (matern_solve.cu: shared-memory route; matern_regs.cuh: register route).
//
// The covariance kind is a template parameter of the routes' code, never a
// run-time branch of it: Closed<T, FAST> is the Matern at 0.5, 1.5 or 2.5
// (its index a run-time int, as it always was), General<T> the built-in
// Matern at any other smoothness, with log K_nu evaluated per pair on the
// device from the constants of one GenParams<T> kernel parameter.  The
// closed-form instances compile to the code they had before General
// existed.

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

// ---------------------------------------------------------------- log K_nu
// The algorithm of kernels/bessel.py (the JAX package's kernels/bessel.py),
// element by element: nu = mu + k with k = clamp(round(nu), 0, 24), K_mu and
// K_{mu+1} by Temme's series (the value of its 40 terms; a lane leaves once
// no later term can change its sums) for x <= 3 or Steed's CF2 (at most 64
// steps; a lane leaves once its own value has converged, with h and s as
// the frozen-lane loop leaves them) for x > 3, then the ratio climb to
// K_nu.  Everything that depends on nu alone is computed once a launch on
// the host in float64 (kernels/matern_solve.py `general_params`, the same
// layout: KV_WORDS doubles an order, then nu, c0, dnu0, 1 / (2 h)) and
// arrives as one kernel parameter.

constexpr int TEMME_TERMS = 40;
constexpr int CF2_STEPS = 64;
constexpr int KV_WORDS = 8 + 3 * TEMME_TERMS;

template <typename T>
struct KvConst {
  T mu, mu2, fact;      // fact = pi mu / sin(pi mu) (small_pimu guarded)
  T gam1, gam2;         // Temme's gamma_1, gamma_2 (small_mu guarded)
  T hgp, hgm;           // 0.5 Gamma(1 + mu), 0.5 Gamma(1 - mu)
  int k;                // climb steps
  T rmm[TEMME_TERMS];   // 1 / (i^2 - mu^2), i = 1 ... 40
  T rm[TEMME_TERMS];    // 1 / (i - mu)
  T rp[TEMME_TERMS];    // 1 / (i + mu)
};

// the general Matern's constants: log K at nu, nu + h and |nu - h| (h the
// central-difference step of d/dnu), c0 = (1 - nu) log 2 - lgamma(nu),
// dnu0 = -log 2 - digamma(nu), inv2h = 1 / (2 h)
template <typename T>
struct GenParams {
  KvConst<T> kv[3];
  T nu, c0, dnu0, inv2h;
};

template <typename T>
GenParams<T> gen_params(const double* w) {
  GenParams<T> p;
  for (int e = 0; e < 3; ++e) {
    const double* v = w + e * KV_WORDS;
    KvConst<T>& c = p.kv[e];
    c.mu = (T)v[0];
    c.mu2 = (T)v[1];
    c.fact = (T)v[2];
    c.gam1 = (T)v[3];
    c.gam2 = (T)v[4];
    c.hgp = (T)v[5];
    c.hgm = (T)v[6];
    c.k = (int)v[7];
    for (int i = 0; i < TEMME_TERMS; ++i) {
      c.rmm[i] = (T)v[8 + i];
      c.rm[i] = (T)v[8 + TEMME_TERMS + i];
      c.rp[i] = (T)v[8 + 2 * TEMME_TERMS + i];
    }
  }
  const double* s = w + 3 * KV_WORDS;
  p.nu = (T)s[0];
  p.c0 = (T)s[1];
  p.dnu0 = (T)s[2];
  p.inv2h = (T)s[3];
  return p;
}

// log K_nu(x); with RATIO also K_{nu+1}(x) / K_nu(x), the climb's next
// ratio (the x-derivative's term)
template <typename T, bool RATIO>
__device__ __forceinline__ T log_kv(const KvConst<T>& c, T x, T* ratio) {
  x = x > T(1e-30) ? x : T(1e-30);
  T kmu, kmu1, shift = T(0);      // K_mu, K_{mu+1}, both times e^shift
  if (x <= T(3)) {
    const T x2 = T(0.5) * x;
    const T d = -log(x2);
    const T e = c.mu * d;
    const T ee = exp(e), iee = T(1) / ee;
    const T fact2 = fabs(e) < T(1e-3) ? T(1) + e * e / T(6) : sinh(e) / e;
    T ff = c.fact * (c.gam1 * (T(0.5) * (ee + iee)) + c.gam2 * fact2 * d);
    T p = ee * c.hgp, q = iee * c.hgm, cc = T(1);
    const T d2 = x2 * x2;
    T ksum = ff, ksum1 = p;
    // From the third term on the terms fall in size (cc by x^2 / 4i <=
    // 2.25 / i, ff, p and q by about 1 / i), so once a term's bounds are
    // below an eighth of an ulp of both sums no later term changes either
    // sum: the loop leaves there with the 40 terms' value, bit for bit
    constexpr T QULP = T(sizeof(T) == 8 ? 0x1p-55 : 0x1p-26);
#pragma unroll
    for (int i = 1; i <= TEMME_TERMS; ++i) {
      ff = (T(i) * ff + p + q) * c.rmm[i - 1];
      cc *= d2 * T(1.0 / i);
      p *= c.rm[i - 1];
      q *= c.rp[i - 1];
      const T t = cc * ff, t1 = cc * (p - T(i) * ff);
      ksum += t;
      ksum1 += t1;
      if (i >= 3 && fabs(t) <= QULP * fabs(ksum) &&
          cc * (fabs(p) + T(i) * fabs(ff)) <= QULP * fabs(ksum1))
        break;
    }
    kmu = ksum;
    kmu1 = ksum1 * T(2) / x;
  } else {
    const T a1 = T(0.25) - c.mu2;
    T b = T(2) * (T(1) + x), dd = T(1) / b, h = dd, delh = dd;
    T q1 = T(0), q2 = T(1), q = a1, cc = a1, a = -a1;
    T s = T(1) + q * delh;
    const T eps = sizeof(T) == 8 ? T(1e-16) : T(1e-8);
    for (int i = 2; i <= CF2_STEPS; ++i) {
      const T an = a - T(2 * (i - 1));
      const T cn = -an * cc / T(i);
      // a1 == 0 (half-integer mu): c stays 0, qnew is unused
      const T qnew = (q1 - b * q2) / (an == T(0) ? T(1) : an);
      const T qn = q + cn * qnew;
      const T bn = b + T(2);
      const T dn = T(1) / (bn + an * dd);
      const T delhn = (bn * dn - T(1)) * delh;
      h += delhn;
      const T dels = qn * delhn;
      s += dels;
      if (fabs(dels) < fabs(s) * eps) break;
      a = an;
      b = bn;
      cc = cn;
      dd = dn;
      delh = delhn;
      q1 = q2;
      q2 = qnew;
      q = qn;
    }
    h = a1 * h;
    kmu = sqrt(T(3.141592653589793) / (T(2) * x)) / s;
    kmu1 = kmu * (c.mu + x + T(0.5) - h) / x;
    shift = x;
  }
  T r = kmu1 / kmu;               // r_1 = K_{mu+1} / K_mu
  if (c.k == 0) {
    if (RATIO) *ratio = r;
    return log(kmu) - shift;
  }
  // r_{j+1} = 2 (mu + j) / x + 1 / r_j; log K_{mu+k} = log K_{mu+1} + sum
  // of log r_j, j = 2 ... k
  const T ix = T(1) / x;
  T lk = log(kmu1) - shift;
  for (int j = 1; j < c.k; ++j) {
    r = T(2) * (c.mu + T(j)) * ix + T(1) / r;
    lk += log(r);
  }
  if (RATIO) *ratio = T(2) * (c.mu + T(c.k)) * ix + T(1) / r;
  return lk;
}

// ------------------------------------------------------ covariance kinds
// value(s) = g(s) at s > 0; grad(s, &dgds, &dgdnu) = g(s) with dg/ds and,
// for General, dg/dnu

template <typename T, bool FAST = false>
struct Closed {
  static constexpr bool kGeneral = false;
  int nu_idx;
  __device__ __forceinline__ T value(T s) const {
    return matern_g<T, FAST>(s, nu_idx, (T*)nullptr);
  }
  __device__ __forceinline__ T grad(T s, T* dgds, T*) const {
    return matern_g<T, FAST>(s, nu_idx, dgds);
  }
};

// g(s) = 2^(1-nu) / Gamma(nu) s^nu K_nu(s) = exp(c0 + nu log s + log K_nu(s))
// (kernels/covariance.py `_Matern`); dg/ds = g (2 nu / s - K_{nu+1} / K_nu)
// and dg/dnu = g (-log 2 - digamma(nu) + log s + d log K_nu / dnu), the
// last by the central difference of log K at nu + h and |nu - h|
// (covariance.py `_Matern.backward`, bessel.py `log_kv_vjp`)
template <typename T>
struct General {
  static constexpr bool kGeneral = true;
  const GenParams<T>& p;
  __device__ __forceinline__ T value(T s) const {
    return exp(p.c0 + p.nu * log(s) + log_kv<T, false>(p.kv[0], s, nullptr));
  }
  __device__ __forceinline__ T grad(T s, T* dgds, T* dgdnu) const {
    T ratio;
    const T ls = log(s);
    const T g = exp(p.c0 + p.nu * ls + log_kv<T, true>(p.kv[0], s, &ratio));
    *dgds = g * (T(2) * p.nu / s - ratio);
    const T dlk = (log_kv<T, false>(p.kv[1], s, nullptr) -
                   log_kv<T, false>(p.kv[2], s, nullptr)) * p.inv2h;
    *dgdnu = g * (p.dnu0 + ls + dlk);
    return g;
  }
};

// g and dg/ds (dg/dnu for General) at s = dist / rho; g = 1 and the
// derivatives 0 at dist == 0
template <typename T, typename Cov>
__device__ __forceinline__ T matern_corr(const Cov& cov, T dist, T rho,
                                         T* dgds, T* dgdnu) {
  if (!(dist > T(0))) {
    if (dgds) *dgds = T(0);
    if (dgdnu) *dgdnu = T(0);
    return T(1);
  }
  if (!dgds) return cov.value(dist / rho);
  return cov.grad(dist / rho, dgds, dgdnu);
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
