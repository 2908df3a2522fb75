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
// Bound. An MDCL is an implicit GEMM of M = pixels by N = C out of K = T * C
// (3,456 to 9,216). One block of full IAN at one image is 2 * H*W * T * C^2
// multiply-adds: 0.60 G at 8x8x512 (T = 18), 0.91 G at 16x16x256 and at
// 32x32x128 (T = 27), against 38, 15 and 5 MB moved (nearly all of it the two
// tap tensors). In float32 outside the tensor cores (67 TFLOP/s) that is 18 to
// 27 us; the first version of this kernel, a float32 FFMA GEMM, ran at 3 to 4x
// that at one image and 40 % of it at 128. On the tensor cores in TF32
// (495 TFLOP/s) at three products per multiply-add (below) the operations
// take 11 us at 16x16x256 and 32x32x128, and at 8x8x512 the 38 MB of taps at
// 3.35 TB/s bound it instead (11.35 us). PERF.md has both bounds and the
// measured times.
//
// Accuracy: 3xTF32. One TF32 product keeps 10 mantissa bits per operand and
// misses float32 by about 1e-3 relative on these 9,216-term sums, more than
// the port's parity allows. So every operand is split, v = hi + lo with
// hi = tf32(v) and lo = tf32(v - hi) (cvt.rna, round to nearest, ties away),
// and each tile product is lo*hi + hi*lo + hi*hi, the small terms first, into
// float32 accumulators: float32 accuracy (lo*lo, about 2^-22 relative, is
// dropped). tests/test_torch_mdblock.py emulates both on the CPU. One thing
// the emulation does not show: an mma adds its products and the accumulator
// it is given with truncation, so a sum carried in the accumulator over all
// 3,456 to 9,216 steps drifts toward zero by about one float32 rounding per
// mma; each 16-channel step therefore starts from zero and is added to the
// running sum by an ordinary float32 add.
//
// Design. The TPU kernel holds a block of images, both tap tensors and the
// intermediate in VMEM and runs both MDCLs in one body. Here one image's
// intermediate (up to 512 KB) is larger than a block's shared memory, and
// MDCL2 at a pixel needs MDCL1 at every channel within three pixels, so the
// block is one MDCL kernel launched twice: the first writes
// h1 = lrelu(s1 * MDCL1(lrelu(s0 * x + t0)) + t1), which stays in L2, the
// second reads h1 and adds the raw x. A block of eight warps computes a
// 64-pixel x 128-channel tile, each warp 32 x 32 of it as 2 x 4 fragments of
// mma.sync m16n8k8 TF32, over steps of one tap and 16 input channels staged
// in a ring of two shared-memory stages: while the tensor cores work on one
// stage, the operands of the next step are loaded into registers, to be
// stored into the other after the products, the activations with the
// prologue affine, lrelu and zero border applied on the way (the operand is
// read as it lies: a channel plane is contiguous in pixels, shifted by the
// tap's offset), and both split into hi and lo planes once, at that store.
// The step's sums are added to the running sums after it (Accuracy, above).
// Stage rows are padded to 8 words beyond a multiple of 32, so that the
// fragment loads (eight rows by four columns a warp) hit 32 distinct banks.
// What bounds this kernel on the card is the staging of the operands (the
// loads, the prologue, the split and the stores into shared memory) more
// than the products: against a 64 x 64 tile the 128-wide tile halves the
// activations' staging per product and was faster in proportion. Versions
// on wgmma (64 x 64, 64 x 128, and 128 x 128 tiles counted over the batch,
// both operands split into K-major planes) computed the same sums; the best
// of them, scripts/mdblock_wgmma.cu, is faster at batch 128 but slower per
// decode at one image, the editor's shape (PERF.md has the times).
// At batch 1 the output has only 4 to 16 tiles for 132 SMs and the inner
// dimension is long, so the inner dimension is cut into slices over
// blockIdx.y, as rgb_beta_head.cu cuts its trunk: each slice writes its
// partial sums and a small second launch adds them in a fixed order and
// applies the epilogue (deterministic, no atomics). With one slice the
// epilogue runs in the product kernel itself. The wrapper picks the number of
// slices (npe_tpu_torch/ops/kernels/mdblock.py) so that all blocks run in one
// wave of two a multiprocessor (__launch_bounds__ holds the registers to
// that; 52 KB of shared memory a block).
//
// This file is the float32 form. The bf16 form is mdblock_bf16.cu, a kernel
// of its own (wgmma over tap tiles and halo tiles brought by TMA).
//
// Left for a later change: staging that moves fewer bytes per product (a
// halo tile of the activations shared by all taps of a branch; TMA for the
// tap tiles, split once per call rather than per tile), then wgmma behind
// it. mdblock_bwd.cu's input gradient has both.
//
// The input gradient (npe_tpu's `_fused_bwd`) is mdblock_bwd.cu's, a kernel
// of its own over pixel-major operands.

#include <cuda_runtime.h>

#include <cstdint>

#include "dynamic_smem.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps, 2 (pixels) x 4 (channels) of 32 x 32
constexpr int kBlocksPerSm = 2;
constexpr int kTileP = 64;     // pixels of a tile
constexpr int kTileC = 128;    // output channels of a tile
constexpr int kStep = 16;      // input channels of one stage
constexpr int kRowA = kTileP + 8;  // words per stage row: both 8 mod 32 banks
constexpr int kRowW = kTileC + 8;
// two stages of (hi, lo) x (activations, taps)
constexpr int kSmemBytes = 2 * 2 * kStep * (kRowA + kRowW) * static_cast<int>(sizeof(float));
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

// v = hi + lo, both TF32 (cvt.rna: round to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// c += a * b for one m16n8k8 TF32 fragment, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b: the same product into a sum that starts from zero.
__device__ __forceinline__ void mma_tf32_first(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// One MDCL over the slice blockIdx.y of its inner dimension.
//   in       (batch, channels, height, width)
//   aff_in   rows (s, t) of the prologue lrelu(s * in + t), or null: in as it is
//   taps     (9 * branches.n, channels, channels)
//   aff_out  null: dst is the partial sums (batch, slices, channels, height, width);
//            else rows (s, t) of the epilogue and dst is the finished map
//   resid    added before the epilogue's affine, or null
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mdcl_kernel(const float* __restrict__ in, const float* __restrict__ aff_in,
            const float* __restrict__ taps, Branches branches, float* __restrict__ dst,
            const float* __restrict__ aff_out, const float* __restrict__ resid, int channels,
            int height, int width, int units_per_split) {
  // (stage, hi / lo, input channel x pixel) and (stage, hi / lo, input
  // channel x output channel)
  extern __shared__ __align__(16) float smem[];
  float (*as)[2][kStep * kRowA] = reinterpret_cast<float (*)[2][kStep * kRowA]>(smem);
  float (*ws)[2][kStep * kRowW] = reinterpret_cast<float (*)[2][kStep * kRowW]>(smem + 2 * 2 * kStep * kRowA);
  const int hw = height * width;
  const int tiles_p = hw / kTileP;
  const int tile_p = blockIdx.x % tiles_p, tile_c = blockIdx.x / tiles_p;
  const int split = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, tig = lane % 4;                 // the fragments' row group and column
  const int wm = 32 * (warp % 2), wn = 32 * (warp / 2);   // the warp's pixels and channels in the tile
  // What this thread stages: one pixel of the input channels lk, lk + 4, ..;
  // and four output channels of the tap rows wr and wr + 8.
  const int lp = tid % kTileP, lk = tid / kTileP;
  const int pix = tile_p * kTileP + lp;
  const int py = pix / width, px = pix % width;
  const int wc = 4 * (tid % 32), wr = tid / 32;
  const bool wc_ok = tile_c * kTileC + wc < channels;
  const int units_per_tap = channels / kStep;

  // (16-pixel fragment, 8-channel fragment, element): the running sums, and
  // the tensor cores' sums over the current step
  float acc[2][4][4], step[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // The next step's operands as they lie in memory (the prologue and the
  // split wait until they are stored, so that the loads stay in flight behind
  // the products), whether this thread's pixel is inside the image, and its
  // first channel.
  float a_next[4];
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
    for (int e = 0; e < 4; ++e)
      a_next[e] = inside_next
                      ? __ldg(in + (static_cast<size_t>(n) * channels + c_next + 4 * e) * hw + y * width + x)
                      : 0.0f;
    const float* wsrc = taps + (static_cast<size_t>(t) * channels + c0 + wr) * channels + tile_c * kTileC + wc;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      w_next[e] = wc_ok ? __ldg(reinterpret_cast<const float4*>(wsrc + static_cast<size_t>(8 * e) * channels))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  // The prologue on the activations, then both operands split into stage s.
  auto store = [&](int s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = a_next[e];
      if (aff_in != nullptr && inside_next) {
        const int c = c_next + 4 * e;
        v = lrelu(fmaf(__ldg(aff_in + c), v, __ldg(aff_in + channels + c)));
      }
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      as[s][0][(lk + 4 * e) * kRowA + lp] = __uint_as_float(hi);
      as[s][1][(lk + 4 * e) * kRowA + lp] = __uint_as_float(lo);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v[4] = {w_next[e].x, w_next[e].y, w_next[e].z, w_next[e].w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(v[q], hi[q], lo[q]);
      *reinterpret_cast<uint4*>(&ws[s][0][(wr + 8 * e) * kRowW + wc]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(&ws[s][1][(wr + 8 * e) * kRowW + wc]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  const int first = split * units_per_split, last = first + units_per_split;
  fetch(first);
  store(0);
  __syncthreads();
  for (int unit = first; unit < last; ++unit) {
    const int s = (unit - first) & 1;
    const bool more = unit + 1 < last;
    if (more) fetch(unit + 1);
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 8) {
      // A fragment: (row, k), (row + 8, k), (row, k + 4), (row + 8, k + 4)
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (kk + tig) * kRowA + wm + 16 * i + grp;
        const int off[4] = {0, 8, 4 * kRowA, 4 * kRowA + 8};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a_hi[i][q] = __float_as_uint(as[s][0][at + off[q]]);
          a_lo[i][q] = __float_as_uint(as[s][1][at + off[q]]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B fragment: (k, column), (k + 4, column)
        const int at = (kk + tig) * kRowW + wn + 8 * j + grp;
        const uint32_t b_hi[2] = {__float_as_uint(ws[s][0][at]), __float_as_uint(ws[s][0][at + 4 * kRowW])};
        const uint32_t b_lo[2] = {__float_as_uint(ws[s][1][at]), __float_as_uint(ws[s][1][at + 4 * kRowW])};
        // lo*hi, then hi*lo, then hi*hi into each sum
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (kk == 0) mma_tf32_first(step[i][j], a_lo[i], b_hi);
          else mma_tf32(step[i][j], a_lo[i], b_hi);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(step[i][j], a_hi[i], b_lo);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(step[i][j], a_hi[i], b_hi);
      }
    }
    // The tensor cores align a sum to its largest term and truncate what
    // falls below (round toward zero), the running sum included: folded
    // into `acc` on every product that bias grows with the number of steps
    // (past the port's tolerance on full IAN's 8x8x512 block at batch 8).
    // So each step's sums start from zero and are added to `acc` in float32.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += step[i][j][e];
    if (more) store(s ^ 1);
    __syncthreads();
  }

  // Element e of fragment (i, j) is pixel wm + 16i + grp (+ 8 for e >= 2) and
  // channel wn + 8j + 2 tig (+ 1 for odd e) of the tile.
  const size_t image = aff_out == nullptr ? static_cast<size_t>(n) * gridDim.y + split : n;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int co = tile_c * kTileC + wn + 8 * j + 2 * tig + odd;
      if (co >= channels) continue;
      const float s_out = aff_out == nullptr ? 0.0f : __ldg(aff_out + co);
      const float t_out = aff_out == nullptr ? 0.0f : __ldg(aff_out + channels + co);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int lower = 0; lower < 2; ++lower) {
          const size_t at = (image * channels + co) * hw + tile_p * kTileP + wm + 16 * i + grp + 8 * lower;
          float v = acc[i][j][2 * lower + odd];
          if (aff_out != nullptr) {
            if (resid != nullptr) v += resid[at];
            v = lrelu(fmaf(s_out, v, t_out));
          }
          dst[at] = v;
        }
      }
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
    mdcl_kernel<<<grid, kThreads, kSmemBytes, s>>>(in, aff_in, taps, branches, out, aff_out, resid, channels,
                                                   height, width, units_per_split);
    return cudaGetLastError();
  }
  mdcl_kernel<<<grid, kThreads, kSmemBytes, s>>>(in, aff_in, taps, branches, partial, nullptr, nullptr,
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
  cudaError_t err = npe::allow_dynamic_smem<mdcl_kernel>(kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Branches branches;
  branches.n = n_branches;
  for (int b = 0; b < kMaxBranches; ++b) branches.dilation[b] = b < n_branches ? dilations[b] : 0;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(aff);
  err = mdcl(xf, af, static_cast<const float*>(taps1), branches,
                         static_cast<float*>(partial), static_cast<float*>(h1), af + 2 * channels,
                         nullptr, batch, channels, height, width, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = mdcl(static_cast<const float*>(h1), nullptr, static_cast<const float*>(taps2), branches,
             static_cast<float*>(partial), static_cast<float*>(out), af + 4 * channels, xf, batch,
             channels, height, width, splits, s);
  return static_cast<int>(err);
}
