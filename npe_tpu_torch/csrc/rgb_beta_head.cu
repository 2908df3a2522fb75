// rgb_beta_head: the whole RGB-Beta head, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// npe_tpu/ops/pallas/mdcl_kernels.py:rgb_beta_head_pallas (body
// `_beta_head_kernel`): the trunk MDCLs R / G_a / B_a over the decoder's last
// feature map, as nine tap products over its space-to-depth(4) form
// (16*C -> 96 planes per cell), then the autoregressive tail of
// rgb_beta_tail.cuh.
//
//   trunk[co, cell] = sum_t sum_k xs[k, cell + offset_t] * tr[t, k, co]
//   xs[c*16 + p*4 + q, (i, j)] = x[c, 4i + p, 4j + q],  zero outside the map
//
// Bound: operations. At C = 64 and one 64x64 image the trunk is 226 M
// multiply-adds (256 cells x 9 taps x 1024 x 96), the tail 7 M: 7.0 us at
// 67 TFLOP/s of float32, against 4.9 MB moved (3.5 MB of it the trunk's tap
// matrices), 1.5 us at 3.35 TB/s. TF32 and the tensor cores are not used:
// the port's parity is float32.
//
// Design. The TPU kernel keeps one image's whole packed input and all taps
// in VMEM and walks the batch on a sequential grid. One SM could do the same
// only at 1/132 of the card, and a brush stroke decodes one image, so the
// trunk product is cut three ways into independent blocks: four tiles of 64
// cells (four cell rows), up to 36 slices of the inner dimension (taps x
// channel pairs), and the batch. A block computes its 64 x 96 partial sums
// with a 4 x 6 register tile per thread out of shared-memory sub-tiles of 32
// inner steps (two channels x 16 positions), reading x as NCHW rows
// (coalesced) and scattering them into space-to-depth order on the way into
// shared memory, so no packed copy of x ever exists. With more than one slice
// the partial sums go to a scratch buffer (batch, slices, 96, 16, 16) and a
// small second launch adds the slices in order over the whole card
// (deterministic, no atomics; left to the first tail's one block per image,
// adding 36 slices took longer than the tail itself). The last launch, the
// tail kernel of rgb_beta_tail.cuh (an image cut into row groups over many
// blocks), runs the autoregressive stages and writes the image. The wrapper
// picks the number of slices from the batch
// (npe_tpu_torch/ops/kernels/rgb_beta_head.py). No double buffering, no TMA,
// no wgmma: a later change's work.

#include "rgb_beta_tail.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCellsW = 16;     // cells per row: the map is 64 pixels wide
constexpr int kTileCells = 64;  // four cell rows
constexpr int kSteps = 32;      // inner steps per sub-tile: 2 channels x 16 positions
constexpr int kXStride = kTileCells + 8;  // pads away the scatter's bank conflicts
constexpr int kCo = 6 * npe::kRR;         // 96 trunk planes

__global__ void __launch_bounds__(kThreads)
head_trunk_kernel(const float* __restrict__ x, const float* __restrict__ tr,
                  float* __restrict__ sums, int channels, int hh, int units_per_split) {
  __shared__ __align__(16) float xs[kSteps * kXStride];
  __shared__ __align__(16) float ws[kSteps * kCo];
  const int tile = blockIdx.x, split = blockIdx.y, n = blockIdx.z;
  const int height = 4 * hh, width = 4 * kCellsW;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // cells 4*tx .. 4*tx+3 of the tile
  const int ty = tid / 16;  // planes 6*ty .. 6*ty+5
  const int units_per_tap = channels / 2;

  float acc[4][6];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) acc[a][b] = 0.0f;

  for (int unit = split * units_per_split; unit < (split + 1) * units_per_split; ++unit) {
    const int t = unit / units_per_tap;
    const int c0 = 2 * (unit - t * units_per_tap);
    const int dy = t / 3 - 1, dx = t % 3 - 1;

    // x sub-tile: 2 channels x 16 pixel rows x 64 pixel columns, shifted by
    // the tap's cell offset, zero outside the map, into (step, cell) order.
#pragma unroll
    for (int e = 0; e < (2 * 16 * 64) / kThreads; ++e) {
      const int idx = tid + kThreads * e;
      const int xc = idx % 64, yy = (idx / 64) % 16, cl = idx / 1024;
      const int y = 4 * (4 * tile + dy) + yy, xsrc = xc + 4 * dx;
      float v = 0.0f;
      if (y >= 0 && y < height && xsrc >= 0 && xsrc < width)
        v = x[(static_cast<size_t>(n * channels + c0 + cl) * height + y) * width + xsrc];
      xs[(cl * 16 + (yy % 4) * 4 + (xc % 4)) * kXStride + (yy / 4) * kCellsW + xc / 4] = v;
    }
    // tap sub-tile: rows c0*16 .. c0*16+31 of tr[t], 32 x 96 contiguous floats
    const float4* wsrc =
        reinterpret_cast<const float4*>(tr + (static_cast<size_t>(t) * 16 * channels + c0 * 16) * kCo);
#pragma unroll
    for (int e = 0; e < (kSteps * kCo / 4) / kThreads; ++e)
      reinterpret_cast<float4*>(ws)[tid + kThreads * e] = __ldg(wsrc + tid + kThreads * e);
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < kSteps; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[k * kXStride + 4 * tx]);
      const float2* wp = reinterpret_cast<const float2*>(&ws[k * kCo + 6 * ty]);
      const float2 w0 = wp[0], w1 = wp[1], w2 = wp[2];
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float wv[6] = {w0.x, w0.y, w1.x, w1.y, w2.x, w2.y};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 6; ++b) acc[a][b] = fmaf(xa[a], wv[b], acc[a][b]);
    }
    __syncthreads();
  }

  const int cells = hh * kCellsW;
  float* dst = sums + static_cast<size_t>(n * gridDim.y + split) * kCo * cells +
               tile * kTileCells + 4 * tx;
#pragma unroll
  for (int b = 0; b < 6; ++b)
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(6 * ty + b) * cells) =
        make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
}

// trunk[n, i] = sum over the slices s, in order, of partial[n, s, i].
__global__ void __launch_bounds__(kThreads)
add_slices_kernel(const float* __restrict__ partial, float* __restrict__ trunk, int splits,
                  int per_image) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= per_image) return;
  const float* p = partial + static_cast<size_t>(blockIdx.y) * splits * per_image + i;
  float s = p[0];
  for (int k = 1; k < splits; ++k) s += p[static_cast<size_t>(k) * per_image];
  trunk[static_cast<size_t>(blockIdx.y) * per_image + i] = s;
}

}  // namespace

// x: (batch, channels, 4*hh, 64) float32 NCHW, channels even, hh a multiple of
// 4; tr: (9, 16*channels, 96); tg: (9, 32, 32); tb: (9, 64, 32); trunk:
// scratch (batch, 96, hh, 16); partial: scratch (batch, splits, 96, hh, 16),
// unused when splits is 1 (splits divides 9*channels/2); out:
// (batch, 3, 4*hh, 64); tail_rows: the tail's cell rows a block (a divisor
// of hh). All contiguous and 16-byte aligned. Two or three launches on
// `stream`; returns the first CUDA error code (0 = all launched).
extern "C" int npe_rgb_beta_head(const void* x, const void* tr, const void* tg, const void* tb,
                                 void* trunk, void* partial, void* out, int batch, int channels,
                                 int hh, int splits, int tail_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sums = static_cast<float*>(splits > 1 ? partial : trunk);
  head_trunk_kernel<<<dim3(hh / 4, splits, batch), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(tr), sums, channels, hh,
      9 * (channels / 2) / splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int per_image = kCo * hh * kCellsW;
    add_slices_kernel<<<dim3((per_image + kThreads - 1) / kThreads, batch), kThreads, 0, s>>>(
        sums, static_cast<float*>(trunk), splits, per_image);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return npe::launch_tail<true>(static_cast<const float*>(trunk), static_cast<const float*>(tg),
                                static_cast<const float*>(tb), static_cast<float*>(out), batch, hh,
                                kCellsW, tail_rows, s);
}
