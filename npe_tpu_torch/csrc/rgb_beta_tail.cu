// rgb_beta_tail: the RGB-Beta head's autoregressive tail as one kernel,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// npe_tpu/ops/pallas/mdcl_kernels.py:rgb_beta_tail_pallas (body
// `_beta_tail_kernel`). What it computes, what bounds it, how an image is
// cut over blocks and how it is laid out are in rgb_beta_tail.cuh, which
// holds the device code.

#include "rgb_beta_tail.cuh"

// trunk: (batch, 96, hh, ww) float32 component-major pre-activations; tg:
// (9, 32, 32); tb: (9, 64, 32); out: (batch, 48, hh, ww). All contiguous and
// 16-byte aligned; rows (the cell rows of a block) divides hh. Launches on
// `stream` and returns the CUDA error code.
extern "C" int npe_rgb_beta_tail(const void* trunk, const void* tg, const void* tb, void* out,
                                 int batch, int hh, int ww, int rows, void* stream) {
  return npe::launch_tail<false>(static_cast<const float*>(trunk),
                                 static_cast<const float*>(tg), static_cast<const float*>(tb),
                                 static_cast<float*>(out), batch, hh, ww, rows,
                                 static_cast<cudaStream_t>(stream));
}
