// H1 and H5, register route, float instances (the code is matern_regs.cuh).
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
                                 double sig2, double rho, int nu_idx, float* x,
                                 void* stream) {
  if (n == 0) return 0;
  return Sizes::fwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, x, (cudaStream_t)stream);
}

int gpv_matern_solve_e0_bwd_regs_f32(const float* locs, int d, const int* NN,
                                     const uint8_t* valid,
                                     const uint8_t* resp,
                                     const float* nug_point, int n, int F,
                                     double sig2, double rho, int nu_idx,
                                     const float* x, const float* xbar,
                                     double* dpar, float* dslot, void* stream) {
  if (n == 0) return 0;
  return Sizes::bwd(F, locs, d, NN, valid, resp, nug_point, n, F, sig2, rho,
                    nu_idx, x, xbar, dpar, dslot, (cudaStream_t)stream);
}

}  // extern "C"
