// The RGB-Beta head's autoregressive tail, hand-written for Hopper (sm_90a).
// Device code shared by rgb_beta_tail.cu (the tail alone) and
// rgb_beta_head.cu (the whole head: trunk product, then this tail).
//
// Computes what the Pallas TPU kernels' tail computes
// (npe_tpu/ops/pallas/mdcl_kernels.py: `_beta_tail_kernel`, and the last two
// thirds of `_beta_head_kernel`). Per image, over a (hh, ww) grid of
// space-to-depth(4) cells, with rr = 16 planes per component:
//   red = sigmoid(trunk[0:2rr])
//   grn = sigmoid(trunk[2rr:4rr] + sum_t shift_t(red)        @ tg[t])   2rr -> 2rr
//   blu = sigmoid(trunk[4rr:6rr] + sum_t shift_t([red, grn]) @ tb[t])   4rr -> 2rr
//   out[c*rr + pos] = 2 * (a / (a + b + 1e-8)) - 1,  (a, b) = colour c's planes pos, rr + pos
// t = 3*(dy+1) + (dx+1) runs over the nine unit cell offsets, dy outer, with a
// zero border; the tap matrices are (9, in, out) row-major.
//
// Layout: planar. trunk is (N, 6*rr, hh, ww): every plane is
// contiguous, so neighbouring threads read neighbouring cells. The TPU kernel
// keeps the same component-major channels on its lanes (NHWC); here the
// component is the slow axis.
//
// Bound: operations. At hh = ww = 16 an image is 7.1 M multiply-adds
// (256 cells x 9 taps x (32*32 + 64*32)) over 252 KB moved: 0.21 us at the
// card's 67 TFLOP/s of float32 against 0.08 us at 3.35 TB/s. Far above both
// stands the dependency chain: G needs all of R in a 3x3 cell neighbourhood
// and B all of R and G, so the three stages of one image are separated by
// barriers and one image is one block on one SM, whose 128 float32 lanes
// alone need 31 us for those multiply-adds (PERF.md has the measured times).
//
// Design: one block of 512 threads per image. The R and G maps live in
// shared memory as 4*rr planes of (hh+2, ww+2) with a zero border, so a tap
// is an unconditional read, and both tap tensors are copied into shared
// memory beside them (81 KB + 108 KB at 16x16, hence the opt-in above
// 48 KB). A thread owns two cells (rows i and i + hh/2 of one column) and
// four positions of a colour, alpha and beta both: 16 sums in registers, so
// it can take the Beta mean itself, and per tap and input plane it reads two
// map values and one tap row as two float4 for 16 multiply-adds. A warp is
// one row of 16 cells for two neighbouring position groups: its map reads
// are 16 neighbouring words and its tap reads two 16-byte chunks, each one
// pass of shared memory. (A first version kept the taps in global memory and
// owned one cell per thread, three loads for eight multiply-adds, two of
// them 16-byte loads of one address for the whole warp: it took 0.16 ms
// where this takes 0.076 ms; PERF.md has both.) Splitting an
// image over a cluster of blocks is left to a later change. All sums are
// float32, fused multiply-adds in the order tap, then channel; expf and the
// division are the accurate ones.

#pragma once

#include <cuda_runtime.h>

namespace npe {

constexpr int kRR = 16;        // r*r planes per component, r = 4
constexpr int kPair = 2 * kRR; // the (alpha, beta) planes of one colour
constexpr int kTailThreads = 512;
constexpr int kTgFloats = 9 * kPair * kPair;      // G_b taps (9, 2rr, 2rr)
constexpr int kTbFloats = 9 * 2 * kPair * kPair;  // B_b taps (9, 4rr, 2rr)

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float beta_mean_f32(float a, float b) {
  return 2.0f * (a / (a + b + 1e-8f)) - 1.0f;
}

// For the thread's two cells, acc0 / acc1[k] += sum over the nine taps and
// the first kIn planes of the maps, for the output planes 4g + k (k < 4,
// alpha) and rr + 4g + (k - 4) (beta). at0 / at1 point at each cell's
// (dy, dx) = (-1, -1) neighbour in plane 0; `taps` is in shared memory.
template <int kIn>
__device__ __forceinline__ void tap_sum(const float* __restrict__ at0, const float* __restrict__ at1,
                                        int pw, int plane, const float* __restrict__ taps, int g,
                                        float acc0[8], float acc1[8]) {
  for (int t = 0; t < 9; ++t) {
    const int off = (t / 3) * pw + (t % 3);
    const float4* w = reinterpret_cast<const float4*>(taps + t * kIn * kPair + 4 * g);
#pragma unroll 4
    for (int ci = 0; ci < kIn; ++ci) {
      const float v0 = at0[off + ci * plane];
      const float v1 = at1[off + ci * plane];
      const float4 wa = w[ci * (kPair / 4)];
      const float4 wb = w[ci * (kPair / 4) + kRR / 4];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc0[k] = fmaf(v0, wv[k], acc0[k]);
        acc1[k] = fmaf(v1, wv[k], acc1[k]);
      }
    }
  }
}

// trunk: (batch, 6*rr, hh, ww). out: (batch, 3*rr, hh, ww), or with kImageOut
// the image itself, (batch, 3, 4*hh, 4*ww). hh is even.
template <bool kImageOut>
__global__ void __launch_bounds__(kTailThreads)
rgb_beta_tail_kernel(const float* __restrict__ trunk, const float* __restrict__ tg, const float* __restrict__ tb,
                     float* __restrict__ out, int hh, int ww) {
  extern __shared__ __align__(16) float smem[];
  const int cells = hh * ww;
  const int pw = ww + 2;
  const int plane = (hh + 2) * pw;
  float* maps = smem;                   // 4*rr planes: R alpha, R beta, G alpha, G beta
  float* tg_s = maps + 4 * kRR * plane;  // 4*rr planes: still 16-byte aligned
  float* tb_s = tg_s + kTgFloats;
  const int n = blockIdx.x;
  const float* trunk_n = trunk + static_cast<size_t>(n) * 6 * kRR * cells;
  auto pre = [&](int ch, int cell) { return trunk_n[ch * cells + cell]; };
  auto store = [&](int colour, int pos, int i, int j, float v) {
    if (kImageOut) {
      const int y = 4 * i + pos / 4, x = 4 * j + pos % 4;
      out[(static_cast<size_t>(n * 3 + colour) * (4 * hh) + y) * (4 * ww) + x] = v;
    } else {
      out[(static_cast<size_t>(n * 3 + colour) * kRR + pos) * cells + i * ww + j] = v;
    }
  };

  for (int idx = threadIdx.x; idx < 4 * kRR * plane; idx += blockDim.x) maps[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < kTgFloats / 4; idx += blockDim.x)
    reinterpret_cast<float4*>(tg_s)[idx] = __ldg(reinterpret_cast<const float4*>(tg) + idx);
  for (int idx = threadIdx.x; idx < kTbFloats / 4; idx += blockDim.x)
    reinterpret_cast<float4*>(tb_s)[idx] = __ldg(reinterpret_cast<const float4*>(tb) + idx);
  __syncthreads();

  // A work item is (column j, position group g, row pair i): its thread owns
  // the cells (i, j) and (i + hh/2, j) and the positions 4g .. 4g+3. Items
  // are numbered so that a warp holds whole rows of cells for neighbouring g.
  const int half = hh / 2;
  const int items = 4 * half * ww;
  for (int colour = 0; colour < 3; ++colour) {
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int j = item % ww;
      const int i = (item / (2 * ww)) % half;
      const int g = 2 * (item / (2 * ww * half)) + (item / ww) % 2;
      float acc[2][8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[0][k] = acc[1][k] = 0.0f;
      const float* at0 = maps + i * pw + j;
      const float* at1 = at0 + half * pw;
      if (colour == 1) tap_sum<kPair>(at0, at1, pw, plane, tg_s, g, acc[0], acc[1]);
      if (colour == 2) tap_sum<2 * kPair>(at0, at1, pw, plane, tb_s, g, acc[0], acc[1]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = i + c * half;
        const int cell = row * ww + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pos = 4 * g + k;
          const float a = sigmoid_f32(pre(colour * kPair + pos, cell) + acc[c][k]);
          const float b = sigmoid_f32(pre(colour * kPair + kRR + pos, cell) + acc[c][4 + k]);
          if (colour < 2) {
            float* centre = maps + (row + 1) * pw + (j + 1);
            centre[(colour * kPair + pos) * plane] = a;
            centre[(colour * kPair + kRR + pos) * plane] = b;
          }
          store(colour, pos, row, j, beta_mean_f32(a, b));
        }
      }
    }
    __syncthreads();
  }
}

// Launches the tail on `stream`; returns the CUDA error code (0 = launched).
template <bool kImageOut>
inline int launch_tail(const float* trunk, const float* tg, const float* tb, float* out, int batch, int hh, int ww, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(4 * kRR) * (hh + 2) * (ww + 2) + kTgFloats + kTbFloats) * sizeof(float);
  // The opt-in to more than 48 KB of dynamic shared memory sticks to the
  // function on a device, so it is asked for once per device and again only
  // if a larger map comes. (Two threads racing here both set it: harmless.)
  constexpr int kMaxDevices = 64;
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || smem > granted[device]) {
    err = cudaFuncSetAttribute(rgb_beta_tail_kernel<kImageOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) granted[device] = smem;
  }
  rgb_beta_tail_kernel<kImageOut><<<batch, kTailThreads, smem, stream>>>(trunk, tg, tb, out, hh, ww);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace npe
