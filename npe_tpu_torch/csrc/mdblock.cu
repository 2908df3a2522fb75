// mdblock_fused: the inference MDBLOCK, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// npe_tpu/ops/pallas/mdcl_kernels.py:mdblock_fused (body `_kernel`, tap sum
// `_mdcl_sum`):
//
//   y = lrelu(s2 * (x + MDCL2(lrelu(s1 * MDCL1(lrelu(s0 * x + t0)) + t1))) + t2)
//   MDCL(h)[co, p] = sum_t sum_ci h[ci, p + offset_t] * taps[t, ci, co]
//
// with batch norm folded to the per-channel affines (s, t), lrelu of slope
// 0.2, h zero outside the image (after the affine, never before it), and the
// offsets those of a 3x3 at dilation 1 followed by one 3x3 per dilated scale.
// Activations are NCHW float32, taps (T, C, C) as (tap, in, out).
//
// Bound: operations. One block of full IAN at one image is 2 * H*W * T * C^2
// multiply-adds: 0.60 G at 8x8x512 (T = 18), 0.91 G at 16x16x256 and at
// 32x32x128 (T = 27), so 18 to 27 us at 67 TFLOP/s of float32, against 38, 15
// and 5 MB moved (nearly all of it the two tap tensors), 11 us or less at
// 3.35 TB/s. TF32 and the tensor cores are not used: the port's parity is
// float32.
//
// Design. The TPU kernel holds a block of images, both tap tensors and the
// intermediate in VMEM and runs both MDCLs in one body. Here one image's
// intermediate (up to 512 KB) is larger than a block's shared memory, and
// MDCL2 at a pixel needs MDCL1 at every channel within three pixels, so the
// block is one MDCL kernel launched twice: the first writes
// h1 = lrelu(s1 * MDCL1(lrelu(s0 * x + t0)) + t1), which stays in L2, the
// second reads h1 and adds the raw x. An MDCL is a product of (pixels) by
// (taps x channels) by (channels): a block computes a 64-pixel x 64-channel
// tile with an 8 x 4 register tile per thread from shared-memory sub-tiles of
// one tap and 16 input channels, which it fetches into registers one step
// ahead of the products. The operand is read as it lies (a channel plane is
// contiguous in pixels), shifted by the tap's offset, and the prologue affine
// and lrelu are applied on the way into shared memory, after the products of
// the step before, so that the loads stay in flight behind them. At batch 1
// the output has only 8 to 32 tiles for 132 SMs and the inner dimension is
// long (3,456 to 9,216), so the inner dimension is cut into slices over
// blockIdx.y, as rgb_beta_head.cu cuts its trunk: each slice writes its
// partial sums and a small second launch adds them in a fixed order and
// applies the epilogue (deterministic, no atomics). With one slice the
// epilogue runs in the product kernel itself. The wrapper picks the number of
// slices (npe_tpu_torch/ops/kernels/mdblock.py). No TMA, no wgmma: a later
// change's work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileP = 64;  // pixels of a tile
constexpr int kTileC = 64;  // output channels of a tile
constexpr int kStep = 16;   // input channels of one sub-tile
constexpr int kMaxBranches = 8;

// The 3x3 branches of one MDCL: dilation 1 first, then each dilated scale.
struct Branches {
  int n;
  int dilation[kMaxBranches];
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

// lrelu(s * (sum [+ residual]) + t) over four neighbouring pixels of a channel.
__device__ __forceinline__ float4 epilogue(float4 v, const float* resid, float s, float t) {
  if (resid != nullptr) {
    const float4 r = *reinterpret_cast<const float4*>(resid);
    v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
  }
  return make_float4(lrelu(fmaf(s, v.x, t)), lrelu(fmaf(s, v.y, t)), lrelu(fmaf(s, v.z, t)),
                     lrelu(fmaf(s, v.w, t)));
}

// One MDCL over the slice blockIdx.y of its inner dimension.
//   in       (batch, channels, height, width)
//   aff_in   rows (s, t) of the prologue lrelu(s * in + t), or null: in as it is
//   taps     (9 * branches.n, channels, channels)
//   aff_out  null: dst is the partial sums (batch, slices, channels, height, width);
//            else rows (s, t) of the epilogue and dst is the finished map
//   resid    added before the epilogue's affine, or null
__global__ void __launch_bounds__(kThreads)
mdcl_kernel(const float* __restrict__ in, const float* __restrict__ aff_in,
            const float* __restrict__ taps, Branches branches, float* __restrict__ dst,
            const float* __restrict__ aff_out, const float* __restrict__ resid, int channels,
            int height, int width, int units_per_split) {
  __shared__ __align__(16) float as[kStep * kTileP];
  __shared__ __align__(16) float ws[kStep * kTileC];
  const int hw = height * width;
  const int tiles_p = hw / kTileP;
  const int tile_p = blockIdx.x % tiles_p, tile_c = blockIdx.x / tiles_p;
  const int split = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // pixels 4*tx .. 4*tx+3 and 32+4*tx .. 32+4*tx+3 of the tile
  const int ty = tid / 8;  // output channels 4*ty .. 4*ty+3 of the tile
  // What this thread fetches of a sub-tile: one pixel of the eight input
  // channels lk, lk+2, ..; and rows wr and wr+8 of the taps, four columns each.
  const int lp = tid % kTileP, lk = tid / kTileP;
  const int pix = tile_p * kTileP + lp;
  const int py = pix / width, px = pix % width;
  const int wc = 4 * (tid % 16), wr = tid / 16;
  const bool wc_ok = tile_c * kTileC + wc < channels;
  const int units_per_tap = channels / kStep;

  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  // The next sub-tile, fetched one step ahead: the operand as it lies in
  // memory (the prologue waits until the values are stored, so that the loads
  // stay in flight behind the products), whether this thread's pixel of it is
  // inside the image, its first channel, and the taps.
  float a_next[8];
  float4 w_next[2];
  bool inside_next = false;
  int c_next = 0;

  auto fetch = [&](int unit) {
    const int t = unit / units_per_tap;
    const int c0 = kStep * (unit - t * units_per_tap);
    const int dil = branches.dilation[t / 9];
    const int y = py + (t % 9 / 3 - 1) * dil, x = px + (t % 3 - 1) * dil;
    inside_next = y >= 0 && y < height && x >= 0 && x < width;
    c_next = c0 + lk;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      a_next[e] = inside_next
                      ? __ldg(in + (static_cast<size_t>(n) * channels + c_next + 2 * e) * hw + y * width + x)
                      : 0.0f;
    const float* wsrc = taps + (static_cast<size_t>(t) * channels + c0 + wr) * channels +
                        tile_c * kTileC + wc;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      w_next[e] = wc_ok ? __ldg(reinterpret_cast<const float4*>(wsrc + static_cast<size_t>(8 * e) * channels))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };

  const int first = split * units_per_split, last = first + units_per_split;
  fetch(first);
  for (int unit = first; unit < last; ++unit) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = a_next[e];
      if (aff_in != nullptr && inside_next) {
        const int c = c_next + 2 * e;
        v = lrelu(fmaf(__ldg(aff_in + c), v, __ldg(aff_in + channels + c)));
      }
      as[(lk + 2 * e) * kTileP + lp] = v;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(&ws[(wr + 8 * e) * kTileC + wc]) = w_next[e];
    __syncthreads();
    if (unit + 1 < last) fetch(unit + 1);
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k * kTileP + 4 * tx]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k * kTileP + 32 + 4 * tx]);
      const float4 w4 = *reinterpret_cast<const float4*>(&ws[k * kTileC + 4 * ty]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], wv[b], acc[a][b]);
    }
    __syncthreads();
  }

  const size_t image = aff_out == nullptr ? static_cast<size_t>(n) * gridDim.y + split : n;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int co = tile_c * kTileC + 4 * ty + b;
    if (co >= channels) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t at = (image * channels + co) * hw + tile_p * kTileP + 32 * half + 4 * tx;
      float4 v = make_float4(acc[4 * half][b], acc[4 * half + 1][b], acc[4 * half + 2][b],
                             acc[4 * half + 3][b]);
      if (aff_out != nullptr)
        v = epilogue(v, resid == nullptr ? nullptr : resid + at, __ldg(aff_out + co),
                     __ldg(aff_out + channels + co));
      *reinterpret_cast<float4*>(dst + at) = v;
    }
  }
}

// out[n, c, p] = lrelu(s[c] * (sum over the slices, in order, of partial[n, slice, c, p]
//                              [+ resid[n, c, p]]) + t[c]), four pixels a thread.
__global__ void __launch_bounds__(kThreads)
add_slices_kernel(const float* __restrict__ partial, const float* __restrict__ aff_out,
                  const float* __restrict__ resid, float* __restrict__ out, int splits, int channels,
                  int hw) {
  const int per_image = channels * hw;
  const int i = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (i >= per_image) return;
  const float* p = partial + static_cast<size_t>(blockIdx.y) * splits * per_image + i;
  float4 v = *reinterpret_cast<const float4*>(p);
  for (int k = 1; k < splits; ++k) {
    const float4 q = *reinterpret_cast<const float4*>(p + static_cast<size_t>(k) * per_image);
    v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
  }
  const int c = i / hw;
  const size_t at = static_cast<size_t>(blockIdx.y) * per_image + i;
  *reinterpret_cast<float4*>(out + at) =
      epilogue(v, resid == nullptr ? nullptr : resid + at, __ldg(aff_out + c), __ldg(aff_out + channels + c));
}

cudaError_t mdcl(const float* in, const float* aff_in, const float* taps, const Branches& branches,
                 float* partial, float* out, const float* aff_out, const float* resid, int batch,
                 int channels, int height, int width, int splits, cudaStream_t s) {
  const int hw = height * width;
  const dim3 grid((hw / kTileP) * ((channels + kTileC - 1) / kTileC), splits, batch);
  const int units_per_split = 9 * branches.n * (channels / kStep) / splits;
  if (splits == 1) {
    mdcl_kernel<<<grid, kThreads, 0, s>>>(in, aff_in, taps, branches, out, aff_out, resid, channels,
                                          height, width, units_per_split);
    return cudaGetLastError();
  }
  mdcl_kernel<<<grid, kThreads, 0, s>>>(in, aff_in, taps, branches, partial, nullptr, nullptr,
                                        channels, height, width, units_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int quads = channels * hw / 4;
  add_slices_kernel<<<dim3((quads + kThreads - 1) / kThreads, batch), kThreads, 0, s>>>(
      partial, aff_out, resid, out, splits, channels, hw);
  return cudaGetLastError();
}

}  // namespace

// x, h1 (scratch), out: (batch, channels, height, width) float32 NCHW, channels
// a multiple of 16 and height*width a multiple of 64; taps1, taps2:
// (9*n_branches, channels, channels); aff: (6, channels), rows s0, t0, s1, t1,
// s2, t2; partial: scratch (batch, splits, channels, height, width), unused
// when splits is 1 (splits divides 9*n_branches*channels/16); dilations: host
// array of n_branches <= 8 ints. All device tensors contiguous and 16-byte
// aligned. Two to four launches on `stream`; returns the first CUDA error code
// (0 = all launched).
extern "C" int npe_mdblock(const void* x, const void* taps1, const void* taps2, const void* aff,
                           void* h1, void* partial, void* out, int batch, int channels, int height,
                           int width, int n_branches, const int* dilations, int splits,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_branches < 1 || n_branches > kMaxBranches) return static_cast<int>(cudaErrorInvalidValue);
  Branches branches;
  branches.n = n_branches;
  for (int b = 0; b < kMaxBranches; ++b) branches.dilation[b] = b < n_branches ? dilations[b] : 0;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(aff);
  cudaError_t err = mdcl(xf, af, static_cast<const float*>(taps1), branches,
                         static_cast<float*>(partial), static_cast<float*>(h1), af + 2 * channels,
                         nullptr, batch, channels, height, width, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = mdcl(static_cast<const float*>(h1), nullptr, static_cast<const float*>(taps2), branches,
             static_cast<float*>(partial), static_cast<float*>(out), af + 4 * channels, xf, batch,
             channels, height, width, splits, s);
  return static_cast<int>(err);
}
