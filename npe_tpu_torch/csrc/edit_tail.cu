// edit_tail: the Neural Photo Editor's DELTA / blurred-mask / composite tail,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel npe_tpu/ops/pallas/editor_kernels.py:edit_tail
// (body `_kernel`). Per image of shape (n, n, 3) float32 in HWC order:
//   DELTA = xh - recon
//   m     = min(mean_c |DELTA|, 1)
//   mask  = blur(m), then clip(mask + user_mask, 0, 1) when a user mask is given
//   out   = recon + mask * DELTA + (1 - mask) * error
// where blur is scipy.ndimage.gaussian_filter with mode='reflect': two 1-D
// passes over the 2r+1 taps, each boundary index folded as
// `_blur_matrix_np` folds it.
//
// Bound: bytes. The function must read xh, recon and error (3 x 12 n^2 B) and
// the user mask (4 n^2 B) and write the output (12 n^2 B): 213 KB at n = 64,
// 0.064 us at 3.35 TB/s. Its arithmetic (about 60 n^2 operations) is nothing
// beside that. Far above both, the latency of three dependent passes inside
// one block per image sets the time (PERF.md has the measured numbers).
//
// Design: one thread block per image (grid = batch). The TPU kernel moves W
// onto the lanes with a CHW transpose and runs the blur as two dense n x n
// MXU matmuls; neither helps here. This reads HWC as it lies and runs the
// blur as two stencil passes over shared memory, which holds m and the
// row-blurred intermediate (2 n^2 floats, 32 KB at n = 64) and the taps.
// With one block per image the three dependent passes are latency-bound, so
// the block is as wide as a block can be (1024 threads: n^2 / 1024 pixels per
// thread and pass, and more warps in flight to hide the loads). The composite pass
// reads xh and recon a second time (from L2) instead of keeping DELTA in
// registers. All sums are float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int reflect_index(int j, int n) {
  // scipy 'reflect': (d c b a | a b c d | d c b a), folded as often as needed.
  while (j < 0 || j >= n) {
    if (j < 0) j = -j - 1;
    if (j >= n) j = 2 * n - j - 1;
  }
  return j;
}

__global__ void __launch_bounds__(kThreads)
edit_tail_kernel(const float* __restrict__ xh, const float* __restrict__ recon,
                 const float* __restrict__ err, const float* __restrict__ user_mask,
                 const float* __restrict__ taps, int radius, int n,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  const int npix = n * n;
  float* m = smem;            // (n, n) auto mask
  float* rows = smem + npix;  // (n, n) m blurred along H
  float* k = rows + npix;     // 2r+1 taps

  const size_t pix0 = static_cast<size_t>(blockIdx.x) * npix;
  const float* xh_b = xh + 3 * pix0;
  const float* rc_b = recon + 3 * pix0;
  const float* er_b = err + 3 * pix0;
  float* out_b = out + 3 * pix0;

  for (int t = threadIdx.x; t <= 2 * radius; t += blockDim.x) k[t] = taps[t];
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const float s = fabsf(xh_b[3 * p] - rc_b[3 * p]) + fabsf(xh_b[3 * p + 1] - rc_b[3 * p + 1]) +
                    fabsf(xh_b[3 * p + 2] - rc_b[3 * p + 2]);
    m[p] = fminf(s / 3.0f, 1.0f);
  }
  __syncthreads();

  // Blur along H: rows[i, j] = sum_t k[t] m[reflect(i + t - r), j].
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int i = p / n, j = p - (p / n) * n;
    float acc = 0.0f;
    for (int t = -radius; t <= radius; ++t) acc += k[t + radius] * m[reflect_index(i + t, n) * n + j];
    rows[p] = acc;
  }
  __syncthreads();

  // Blur along W, then the mask floor and the composite.
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int i = p / n, j = p - (p / n) * n;
    float mask = 0.0f;
    for (int t = -radius; t <= radius; ++t) mask += k[t + radius] * rows[i * n + reflect_index(j + t, n)];
    if (user_mask != nullptr) mask = fminf(fmaxf(mask + user_mask[pix0 + p], 0.0f), 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r = rc_b[3 * p + c];
      const float d = xh_b[3 * p + c] - r;
      out_b[3 * p + c] = r + mask * d + (1.0f - mask) * er_b[3 * p + c];
    }
  }
}

}  // namespace

// xh, recon, err, out: (batch, n, n, 3) float32, contiguous; user_mask:
// (batch, n, n) float32 or null (no floor, no clip); taps: 2*radius+1 float32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int npe_edit_tail(const void* xh, const void* recon, const void* err,
                             const void* user_mask, const void* taps, int radius,
                             void* out, int batch, int n, void* stream) {
  const size_t smem = (2 * static_cast<size_t>(n) * n + 2 * radius + 1) * sizeof(float);
  edit_tail_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const float*>(recon),
      static_cast<const float*>(err), static_cast<const float*>(user_mask),
      static_cast<const float*>(taps), radius, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
