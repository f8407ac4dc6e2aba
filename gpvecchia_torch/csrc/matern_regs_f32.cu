// H1 and H5, register route, float instances (the code is matern_regs.cuh),
// closed forms and the general Matern (gen != NULL), and H8 and K2 on a
// packed covariance.
// float32 takes FP = 8 ... 64 (from 40 on held to 128 registers, see
// capped()); above 64 the shared-memory route

#include "matern_regs.cuh"

namespace {
using Sizes = gpv::Sizes<float, 8, 16, 24, 32, 40, 48, 56, 64>;
}  // namespace

extern "C" {

int gpv_matern_solve_e0_regs_f32(const float* locs, int d, const int* NN,
                                 const uint8_t* valid, const uint8_t* resp,
                                 const float* nug_point, int n, int F,
                                 double sig2, double rho, int nu_idx,
                                 const double* gen, float* x,
                                 void* stream) {
  if (n == 0) return 0;
  return Sizes::fwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, gen, x, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_regs_f32(const float* locs, int d, const int* NN,
                                     const uint8_t* valid,
                                     const uint8_t* resp,
                                     const float* nug_point, int n, int F,
                                     double sig2, double rho, int nu_idx,
                                     const double* gen, const float* x,
                                     const float* xbar,
                                     double* dpar, float* dslot, void* stream) {
  if (n == 0) return 0;
  return Sizes::bwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, gen, x, xbar, dpar, dslot,
                    (cudaStream_t)stream);
}

int gpv_solve_e0_regs_f32(const float* Cp, int n, int F, float* x,
                          void* stream) {
  if (n == 0) return 0;
  return Sizes::h8(F, Cp, n, F, x, (cudaStream_t)stream);
}

int gpv_solve_e0_bwd_regs_f32(const float* Cp, int n, int F, const float* x,
                              const float* xbar, float* g, void* stream) {
  if (n == 0) return 0;
  return Sizes::k2(F, Cp, n, F, x, xbar, g, (cudaStream_t)stream);
}

}  // extern "C"
