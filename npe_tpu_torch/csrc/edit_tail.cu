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
// beside that. What is left above both is latency: a launch, then the chain
// of loads, blur passes and stores (PERF.md has the measured numbers, and the
// time of an empty kernel launched the same way, scripts/launch_floor.py).
//
// Design: one pass over row bands. The first version gave an image one block
// and chained three passes over the whole image with block barriers, so a
// stroke (batch 1) ran on one SM of 132. Here the grid is (bands, batch) and
// a block owns `rows` rows of one image (the wrapper's `band_rows`: 64 bands
// of one row at batch 1, wider bands as the batch grows). It computes m for
// its rows and the blur radius r either side, folding rows outside the image
// by scipy's reflect (as often as needed, so r may exceed the band and the
// image), blurs along H into its rows, then along W over each whole row
// (reflect at the column edges), adds the user-mask floor, clips, and writes
// the composite of its rows. No block depends on another: one launch, no
// step between blocks. The HWC rows are read and written as float4 (4 pixels
// are 3 float4); a thread issues its composite loads (its float4 of xh,
// recon and error) and its user-mask word first, so that they are in flight
// behind the m and blur passes. Shared memory holds m for rows + 2r rows (the
// W-blurred mask reuses it), the H-blurred rows and the taps. All sums are
// float32.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

__device__ __forceinline__ int reflect_index(int j, int n) {
  // scipy 'reflect': (d c b a | a b c d | d c b a), folded as often as needed.
  while (j < 0 || j >= n) {
    if (j < 0) j = -j - 1;
    if (j >= n) j = 2 * n - j - 1;
  }
  return j;
}

__global__ void edit_tail_kernel(const float* __restrict__ xh, const float* __restrict__ recon,
                                 const float* __restrict__ err, const float* __restrict__ user_mask,
                                 const float* __restrict__ taps, int radius, int n, int rows,
                                 float* __restrict__ out) {
  extern __shared__ float smem[];
  const int span = rows + 2 * radius;  // m rows a band needs
  float* m = smem;                     // (span, n) auto mask; later the final (rows, n) mask
  float* hb = m + span * n;            // (rows, n) m blurred along H
  float* k = hb + rows * n;            // 2r+1 taps
  const int tid = threadIdx.x, threads = blockDim.x;
  const int y0 = blockIdx.x * rows;
  const size_t img = static_cast<size_t>(blockIdx.y) * n * n;
  const int quads = n / 4;             // a row is `quads` groups of 4 pixels, 3 float4 each
  const int chunks = rows * 3 * quads; // float4 of the band's rows

  // what the last pass needs, issued first
  const float4* xh4 = reinterpret_cast<const float4*>(xh + 3 * (img + static_cast<size_t>(y0) * n));
  const float4* rc4 = reinterpret_cast<const float4*>(recon + 3 * (img + static_cast<size_t>(y0) * n));
  const float4* er4 = reinterpret_cast<const float4*>(err + 3 * (img + static_cast<size_t>(y0) * n));
  float4 pre_x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), pre_r = pre_x, pre_e = pre_x;
  if (tid < chunks) {
    pre_x = __ldg(xh4 + tid);
    pre_r = __ldg(rc4 + tid);
    pre_e = __ldg(er4 + tid);
  }
  float pre_um = 0.0f;
  if (user_mask != nullptr && tid < rows * n) pre_um = __ldg(user_mask + img + static_cast<size_t>(y0) * n + tid);

  for (int t = tid; t <= 2 * radius; t += threads) k[t] = taps[t];
  // m over rows y0 - r .. y0 + rows + r - 1, each folded into the image
  for (int i = tid; i < span * quads; i += threads) {
    const int row = i / quads, g = i - row * quads;
    const size_t at = (img + static_cast<size_t>(reflect_index(y0 - radius + row, n)) * n) * 3 / 4 + 3 * g;
    const float4* a = reinterpret_cast<const float4*>(xh) + at;
    const float4* b = reinterpret_cast<const float4*>(recon) + at;
    const float4 a0 = __ldg(a), a1 = __ldg(a + 1), a2 = __ldg(a + 2);
    const float4 b0 = __ldg(b), b1 = __ldg(b + 1), b2 = __ldg(b + 2);
    const float d[12] = {a0.x - b0.x, a0.y - b0.y, a0.z - b0.z, a0.w - b0.w, a1.x - b1.x, a1.y - b1.y,
                         a1.z - b1.z, a1.w - b1.w, a2.x - b2.x, a2.y - b2.y, a2.z - b2.z, a2.w - b2.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float s = fabsf(d[3 * p]) + fabsf(d[3 * p + 1]) + fabsf(d[3 * p + 2]);
      m[row * n + 4 * g + p] = fminf(s / 3.0f, 1.0f);
    }
  }
  __syncthreads();

  // blur along H into the band's rows: hb[i, j] = sum_t k[t] m[reflect(y0 + i + t - r), j]
  for (int p = tid; p < rows * n; p += threads) {
    const int i = p / n, j = p - i * n;
    float acc = 0.0f;
    for (int t = 0; t <= 2 * radius; ++t) acc += k[t] * m[(i + t) * n + j];
    hb[p] = acc;
  }
  __syncthreads();

  // blur along W, the user-mask floor and the clip: the final mask, into m
  for (int p = tid; p < rows * n; p += threads) {
    const int i = p / n, j = p - i * n;
    float mask = 0.0f;
    for (int t = -radius; t <= radius; ++t) mask += k[t + radius] * hb[i * n + reflect_index(j + t, n)];
    if (user_mask != nullptr) {
      const float u = p == tid ? pre_um : __ldg(user_mask + img + static_cast<size_t>(y0) * n + p);
      mask = fminf(fmaxf(mask + u, 0.0f), 1.0f);
    }
    m[p] = mask;
  }
  __syncthreads();

  // the composite, a float4 (four of a row's 3n floats) a thread at a time
  float4* out4 = reinterpret_cast<float4*>(out + 3 * (img + static_cast<size_t>(y0) * n));
  for (int c = tid; c < chunks; c += threads) {
    float4 vx = pre_x, vr = pre_r, ve = pre_e;
    if (c != tid) {
      vx = __ldg(xh4 + c);
      vr = __ldg(rc4 + c);
      ve = __ldg(er4 + c);
    }
    const float xs[4] = {vx.x, vx.y, vx.z, vx.w}, rs[4] = {vr.x, vr.y, vr.z, vr.w}, es[4] = {ve.x, ve.y, ve.z, ve.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mask = m[(4 * c + e) / 3];  // the band's pixels in order: row i, column j at i * n + j
      o[e] = rs[e] + mask * (xs[e] - rs[e]) + (1.0f - mask) * es[e];
    }
    out4[c] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Threads of a block (scripts/launch_floor.py launches its empty kernel by
// the same rule).
int block_threads(int n, int radius, int rows) {
  const int work = std::max((rows + 2 * radius) * (n / 4), rows * n);
  return std::min(1024, std::max(64, (work + 31) / 32 * 32));
}

}  // namespace

// xh, recon, err, out: (batch, n, n, 3) float32, contiguous, 16-byte aligned,
// n a multiple of 4; user_mask: (batch, n, n) float32 or null (no floor, no
// clip); taps: 2*radius+1 float32; rows: the rows of a band, a divisor of n.
// Needs ((rows + 2 radius) n + rows n + 2 radius + 1) * 4 bytes of shared
// memory, at most 48 KB. Launches on `stream` and returns the CUDA error code.
extern "C" int npe_edit_tail(const void* xh, const void* recon, const void* err, const void* user_mask,
                             const void* taps, int radius, void* out, int batch, int n, int rows, void* stream) {
  if (rows < 1 || n % rows || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(rows + 2 * radius) * n + static_cast<size_t>(rows) * n + 2 * radius + 1) *
                      sizeof(float);
  edit_tail_kernel<<<dim3(n / rows, batch), block_threads(n, radius, rows), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const float*>(recon), static_cast<const float*>(err),
      static_cast<const float*>(user_mask), static_cast<const float*>(taps), radius, n, rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
