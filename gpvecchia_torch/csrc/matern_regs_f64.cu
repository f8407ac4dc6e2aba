// H1 and H5, register route, double instances (the code is matern_regs.cuh).
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
                                 double sig2, double rho, int nu_idx, double* x,
                                 void* stream) {
  if (n == 0) return 0;
  return Sizes::fwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, x, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_regs_f64(const double* locs, int d, const int* NN,
                                     const uint8_t* valid,
                                     const uint8_t* resp,
                                     const double* nug_point, int n, int F,
                                     double sig2, double rho, int nu_idx,
                                     const double* x, const double* xbar,
                                     double* dpar, double* dslot, void* stream) {
  if (n == 0) return 0;
  return Sizes::bwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, x, xbar, dpar, dslot, (cudaStream_t)stream);
}

}  // extern "C"
