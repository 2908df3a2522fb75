// staging: a training chunk's uint8 images to float32 in [-1, 1], rows
// gathered by an index vector, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel npe_tpu/ops/pallas/staging.py:stage_uint8_to_tanh
// (body `_kernel`) together with the `jnp.take` that `stage_chunk` fuses
// with it into one program:
//   out[i] = float(src[idx[i]]) * (2/255) - 1        for i < n
// src: (M, C, H, W) uint8; idx: n row numbers (null: the identity);
// out: (n, C, H, W) float32. The port's activations are NCHW, so the TPU
// path's NCHW -> NHWC transpose has no counterpart, and neither has the
// TPU kernel's flat (N, C*H*W) row blocking, which was Mosaic's tiling.
//
// Bound: bytes. Each output pixel costs one byte read and four written, each
// row one index: n * C*H*W * 5 + 8 n bytes, 503 MB at n = 8192 images of
// 3x64x64 (0.150 ms at 3.35 TB/s). One multiply and one subtract per pixel
// are nothing beside that.
//
// Design: one block per output image (grid = n), so a block's index is read
// once, by every thread from the same address (one broadcast load a warp).
// An image is C*H*W contiguous bytes in and 4*C*H*W out. A thread takes one
// 4-byte word (four pixels) and writes one `float4`; neighbouring threads
// take neighbouring words, so a warp reads 128 contiguous bytes and writes
// 512 contiguous bytes with every load and store, and four independent words
// per thread are in flight at a time. (A first version loaded 16 bytes a
// thread and wrote four `float4` that lay 64 bytes from the neighbouring
// thread's: every store half-filled 32 sectors, and it took 3.2 times its
// bound.) C*H*W must be a multiple of 16 and both bases 16-byte
// aligned, so that every row of either side starts on a 16-byte boundary;
// the wrapper checks. The multiply and the subtract are rounded separately
// (`__fmul_rn`, `__fsub_rn`: no FMA contraction), as the plain PyTorch
// version rounds them, so the two agree bit for bit. The kernel trusts the
// indices: the wrapper checks them on the host before they are copied to
// the card.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 to_tanh4(unsigned int word) {
  constexpr float kScale = 2.0f / 255.0f;
  float4 f;
  f.x = __fsub_rn(__fmul_rn(static_cast<float>(word & 0xffu), kScale), 1.0f);
  f.y = __fsub_rn(__fmul_rn(static_cast<float>((word >> 8) & 0xffu), kScale), 1.0f);
  f.z = __fsub_rn(__fmul_rn(static_cast<float>((word >> 16) & 0xffu), kScale), 1.0f);
  f.w = __fsub_rn(__fmul_rn(static_cast<float>(word >> 24), kScale), 1.0f);
  return f;
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const unsigned int* __restrict__ src, const Index* __restrict__ idx,
             float4* __restrict__ out, int words) {
  // words: 4-byte words of one image, C*H*W / 4
  const size_t row = idx == nullptr ? blockIdx.x : static_cast<size_t>(idx[blockIdx.x]);
  const unsigned int* in = src + row * words;
  float4* o = out + static_cast<size_t>(blockIdx.x) * words;
  int w = threadIdx.x;
  for (; w + 3 * kThreads < words; w += 4 * kThreads) {
    const unsigned int a = in[w], b = in[w + kThreads], c = in[w + 2 * kThreads],
                       d = in[w + 3 * kThreads];
    o[w] = to_tanh4(a);
    o[w + kThreads] = to_tanh4(b);
    o[w + 2 * kThreads] = to_tanh4(c);
    o[w + 3 * kThreads] = to_tanh4(d);
  }
  for (; w < words; w += kThreads) o[w] = to_tanh4(in[w]);
}

}  // namespace

// src: (M, chw) uint8, contiguous, 16-byte aligned, chw a multiple of 16;
// idx: n int32 or int64 (idx_is_64) row numbers in [0, M), or null for rows
// 0..n-1; out: (n, chw) float32, 16-byte aligned. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int npe_stage_chunk(const void* src, const void* idx, int idx_is_64, void* out,
                               int n, int chw, void* stream) {
  const int words = chw / 4;
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const unsigned int*>(src);
  auto o = static_cast<float4*>(out);
  if (idx_is_64) {
    stage_kernel<long long><<<n, kThreads, 0, s>>>(in, static_cast<const long long*>(idx), o, words);
  } else {
    stage_kernel<int><<<n, kThreads, 0, s>>>(in, static_cast<const int*>(idx), o, words);
  }
  return static_cast<int>(cudaGetLastError());
}
