// H1 and H5, register route, double instances (the code is matern_regs.cuh),
// closed forms and the general Matern (gen != NULL), and H8 and K2 on a
// packed covariance.
// float64 takes FP = 8 ... 32: from 40 on its rows no longer fit the
// registers (ptxas puts the array in local memory), and the shared-memory
// route takes those F

#include "matern_regs.cuh"

namespace {
using Sizes = gpv::Sizes<double, 8, 16, 24, 32>;
}  // namespace

extern "C" {

int gpv_matern_solve_e0_regs_f64(const double* locs, int d, const int* NN,
                                 const uint8_t* valid, const uint8_t* resp,
                                 const double* nug_point, int n, int F,
                                 double sig2, double rho, int nu_idx,
                                 const double* gen, double* x,
                                 void* stream) {
  if (n == 0) return 0;
  return Sizes::fwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, gen, x, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_regs_f64(const double* locs, int d, const int* NN,
                                     const uint8_t* valid,
                                     const uint8_t* resp,
                                     const double* nug_point, int n, int F,
                                     double sig2, double rho, int nu_idx,
                                     const double* gen, const double* x,
                                     const double* xbar,
                                     double* dpar, double* dslot, void* stream) {
  if (n == 0) return 0;
  return Sizes::bwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, gen, x, xbar, dpar, dslot,
                    (cudaStream_t)stream);
}

int gpv_solve_e0_regs_f64(const double* Cp, int n, int F, double* x,
                          void* stream) {
  if (n == 0) return 0;
  return Sizes::h8(F, Cp, n, F, x, (cudaStream_t)stream);
}

int gpv_solve_e0_bwd_regs_f64(const double* Cp, int n, int F, const double* x,
                              const double* xbar, double* g, void* stream) {
  if (n == 0) return 0;
  return Sizes::k2(F, Cp, n, F, x, xbar, g, (cudaStream_t)stream);
}

}  // extern "C"
