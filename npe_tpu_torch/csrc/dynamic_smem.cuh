// The opt-in a kernel needs before it may launch with more than 48 KB of
// dynamic shared memory, shared by the port's kernels that use that much.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace npe {

// Lets kKernel launch with `bytes` of dynamic shared memory on the current
// device. The opt-in sticks to the function on a device, so it is asked for
// once per device (one cache per kernel) and again only if more bytes come.
// (Two threads racing here both set it: harmless.)
template <auto kKernel>
inline cudaError_t allow_dynamic_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && bytes <= granted[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && device < kMaxDevices) granted[device] = bytes;
  return err;
}

}  // namespace npe
