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
// stands the dependency chain: G needs R in a 3x3 cell neighbourhood and B
// needs R and G in one, so B at a cell depends on R two cells away. The first
// version of this kernel followed the chain with barriers inside one block
// per image, so one image ran on one SM of 132, behind a copy of all 108 KB
// of taps, and took 76 us, slower than its plain version (PERF.md has the
// times).
//
// Design: halo recompute (the first of the two ways to cut an image that
// were weighed; the other, a cluster of blocks per image reading each
// other's R and G rows through distributed shared memory, saves the
// recomputed rows but ties the blocks of an image to one GPC and a cluster
// barrier, and its 8-block portable cluster gives no more blocks than the
// two-row groups here). The grid is batch x groups of `rows` cell rows; the
// wrapper takes the fewest rows that keep all blocks in one wave (one image:
// 16 blocks of one row; a batch of 16: two rows; 128: the whole image). A
// block computes R on its rows +-2 and G on its rows +-1, both zero outside
// the image, and B and the three Beta means on its own rows only: the extra
// G work is two rows a group. Its maps live in shared memory as 4*rr planes
// (R alpha, R beta, G alpha, G beta) of (rows + 5) x (ww + 2) with a zero
// border and a spare row, so a tap is an unconditional read; R is computed
// into them with eight trunk loads in flight a thread. The taps are copied
// into shared memory by 16-byte cp.async in two groups, issued before any
// other work: tg (36 KB) arrives behind the R pass, tb (72 KB) behind the G
// pass. In G and B a thread owns four positions of a colour, alpha and beta
// both, of one cell, or of two cells one row apart where a block has four
// rows or more: 8 sums a cell in registers, so it can take the Beta mean
// itself, and per tap and input plane it reads one tap row as two float4 for
// every cell it owns. A warp is a row of 16 cells for two neighbouring position groups:
// its map reads are 16 neighbouring words and its tap reads two 16-byte
// chunks, each one pass of shared memory. What bounds a block is that chain
// of dependent sums a thread (288 tap-planes for G, 576 for B) and the
// shared-memory reads that feed it. All sums are float32, fused
// multiply-adds in the order tap, then channel, as in the first version;
// expf and the division are the accurate ones.
//
// Left for a later change: a TMA copy of the taps (multicast to the blocks of
// an image in a cluster), and splitting a cell's 8 sums over more threads.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dynamic_smem.cuh"

namespace npe {

constexpr int kRR = 16;        // r*r planes per component, r = 4
constexpr int kPair = 2 * kRR; // the (alpha, beta) planes of one colour
constexpr int kTailThreads = 512;  // the whole-image blocks of a large batch fill 16 warps
constexpr int kHalo = 2;       // R is needed two cell rows beyond a block's rows, G one
constexpr int kMapRows = 2 * kHalo + 1;  // map rows beyond a block's own: the halo, and one spare
constexpr int kTgFloats = 9 * kPair * kPair;      // G_b taps (9, 2rr, 2rr)
constexpr int kTbFloats = 9 * 2 * kPair * kPair;  // B_b taps (9, 4rr, 2rr)

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float beta_mean_f32(float a, float b) {
  return 2.0f * (a / (a + b + 1e-8f)) - 1.0f;
}

__device__ __forceinline__ void tail_cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// For kCells cells one map row apart, acc[c][k] += sum over the nine taps and
// the first kIn planes of the maps, for the output planes 4g + k (k < 4,
// alpha) and rr + 4g + (k - 4) (beta). `at` points at the first cell's
// (dy, dx) = (-1, -1) neighbour in plane 0; `taps` is in shared memory. One
// tap row read serves every cell.
template <int kIn, int kCells>
__device__ __forceinline__ void tap_sum(const float* __restrict__ at, int pw, int plane,
                                        const float* __restrict__ taps, int g, float acc[kCells][8]) {
  for (int t = 0; t < 9; ++t) {
    const int off = (t / 3) * pw + (t % 3);
    const float4* w = reinterpret_cast<const float4*>(taps + t * kIn * kPair + 4 * g);
#pragma unroll 8
    for (int ci = 0; ci < kIn; ++ci) {
      const float4 wa = w[ci * (kPair / 4)];
      const float4 wb = w[ci * (kPair / 4) + kRR / 4];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const float v = at[c * pw + off + ci * plane];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[c][k] = fmaf(v, wv[k], acc[c][k]);
      }
    }
  }
}

// What a block of the kernel works on: one image's trunk, the output, its
// maps and taps in shared memory, and where its rows lie.
struct TailBlock {
  const float* trunk_n;  // (6 rr, hh, ww) of this image
  float* out;
  float* maps;           // 4 rr planes of (rows + 5) x (ww + 2); map row r is cell row i0 - 2 + r
  const float* tg_s;
  const float* tb_s;
  int n, hh, ww, rows, i0, pw, plane;

  __device__ float pre(int ch, int cell) const { return trunk_n[ch * hh * ww + cell]; }

  template <bool kImageOut>
  __device__ void store(int colour, int pos, int i, int j, float v) const {
    if (kImageOut) {
      const int y = 4 * i + pos / 4, x = 4 * j + pos % 4;
      out[(static_cast<size_t>(n * 3 + colour) * (4 * hh) + y) * (4 * ww) + x] = v;
    } else {
      out[(static_cast<size_t>(n * 3 + colour) * kRR + pos) * hh * ww + i * ww + j] = v;
    }
  }

  // A work item is (column j, position group g, kCells map rows from r):
  // its thread owns those cells and the positions 4g .. 4g+3. Items are
  // numbered so that a warp holds a row of cells for neighbouring g.
  template <int kCells>
  __device__ void item(int it, int n_rows, int first_row, int& j, int& r, int& g) const {
    const int groups = n_rows / kCells;
    j = it % ww;
    r = first_row + kCells * ((it / (2 * ww)) % groups);
    g = 2 * (it / (2 * ww * groups)) + (it / ww) % 2;
  }

  // R on the cell rows i0 - 2 .. i0 + rows + 1 inside the image. An item is
  // (column j, position group g, row): its thread issues the eight trunk
  // loads of its planes 4g .. 4g+3 of alpha and beta at once. (Walking the
  // map one slot after another, a load then a sigmoid each, cost a
  // whole-image block about 6 of its 80 us.)
  __device__ void red() const {
    const int lo = max(i0 - kHalo, 0), n_rows = min(i0 + rows + kHalo, hh) - lo;
    for (int it = threadIdx.x; it < 4 * n_rows * ww; it += blockDim.x) {
      const int j = it % ww, row = lo + (it / ww) % n_rows, g = it / (ww * n_rows);
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = pre((k / 4) * kRR + 4 * g + k % 4, row * ww + j);
      float* centre = maps + (row - i0 + kHalo) * pw + j + 1;
#pragma unroll
      for (int k = 0; k < 8; ++k) centre[((k / 4) * kRR + 4 * g + k % 4) * plane] = sigmoid_f32(v[k]);
    }
  }

  // G on the cell rows i0 - 1 .. i0 + rows inside the image, and the red and
  // green Beta means of the block's own rows. With two cells an item, the
  // last item's second cell may lie one row past them: its sums read the
  // spare map row and are dropped.
  template <bool kImageOut, int kCells>
  __device__ void green() const {
    const int lo = max(i0 - 1, 0), hi = min(i0 + rows, hh - 1);
    const int n_items = 4 * ((hi - lo + kCells) / kCells) * ww;
    for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
      int j, r, g;
      item<kCells>(it, hi - lo + kCells - (hi - lo + kCells) % kCells, lo - i0 + kHalo, j, r, g);
      float acc[kCells][8];
#pragma unroll
      for (int c = 0; c < kCells; ++c)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[c][k] = 0.0f;
      tap_sum<kPair, kCells>(maps + (r - 1) * pw + j, pw, plane, tg_s, g, acc);
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const int row = i0 - kHalo + r + c;
        if (row > hi) continue;
        const bool own = row >= i0 && row < i0 + rows;
        float* centre = maps + (r + c) * pw + j + 1;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pos = 4 * g + k;
          const int cell = row * ww + j;
          const float a = sigmoid_f32(pre(kPair + pos, cell) + acc[c][k]);
          const float b = sigmoid_f32(pre(kPair + kRR + pos, cell) + acc[c][4 + k]);
          centre[(kPair + pos) * plane] = a;
          centre[(kPair + kRR + pos) * plane] = b;
          if (own) {
            store<kImageOut>(0, pos, row, j, beta_mean_f32(centre[pos * plane], centre[(kRR + pos) * plane]));
            store<kImageOut>(1, pos, row, j, beta_mean_f32(a, b));
          }
        }
      }
    }
  }

  // B and the blue Beta means on the block's own rows.
  template <bool kImageOut, int kCells>
  __device__ void blue() const {
    for (int it = threadIdx.x; it < 4 * rows / kCells * ww; it += blockDim.x) {
      int j, r, g;
      item<kCells>(it, rows, kHalo, j, r, g);
      float acc[kCells][8];
#pragma unroll
      for (int c = 0; c < kCells; ++c)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[c][k] = 0.0f;
      tap_sum<2 * kPair, kCells>(maps + (r - 1) * pw + j, pw, plane, tb_s, g, acc);
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const int row = i0 - kHalo + r + c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pos = 4 * g + k;
          const int cell = row * ww + j;
          const float a = sigmoid_f32(pre(2 * kPair + pos, cell) + acc[c][k]);
          const float b = sigmoid_f32(pre(2 * kPair + kRR + pos, cell) + acc[c][4 + k]);
          store<kImageOut>(2, pos, row, j, beta_mean_f32(a, b));
        }
      }
    }
  }
};

// trunk: (batch, 6*rr, hh, ww). out: (batch, 3*rr, hh, ww), or with kImageOut
// the image itself, (batch, 3, 4*hh, 4*ww). Block b is image b / (hh / rows),
// cell rows rows * (b % (hh / rows)) onwards; rows divides hh.
template <bool kImageOut>
__global__ void __launch_bounds__(kTailThreads)
rgb_beta_tail_kernel(const float* __restrict__ trunk, const float* __restrict__ tg, const float* __restrict__ tb,
                     float* __restrict__ out, int hh, int ww, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* tg_s = smem;
  float* tb_s = tg_s + kTgFloats;
  float* maps = tb_s + kTbFloats;  // 4*rr planes: R alpha, R beta, G alpha, G beta
  const int groups = hh / rows;
  const int n = blockIdx.x / groups;
  const int cells = hh * ww;
  const TailBlock blk{trunk + static_cast<size_t>(n) * 6 * kRR * cells, out, maps, tg_s, tb_s, n, hh, ww, rows,
                      static_cast<int>(blockIdx.x % groups) * rows, ww + 2, (rows + kMapRows) * (ww + 2)};

  // 1. Both tap tensors on their way into shared memory, tg in the first
  // group, tb in the second.
  for (int idx = threadIdx.x; idx < kTgFloats / 4; idx += blockDim.x)
    tail_cp_async16(tg_s + 4 * idx, tg + 4 * idx);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int idx = threadIdx.x; idx < kTbFloats / 4; idx += blockDim.x)
    tail_cp_async16(tb_s + 4 * idx, tb + 4 * idx);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. The maps zeroed (border columns, rows outside the image, G planes),
  // then R on the map rows inside the image.
  for (int idx = threadIdx.x; idx < 2 * kPair * blk.plane; idx += blockDim.x) maps[idx] = 0.0f;
  __syncthreads();
  blk.red();
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // 3. G, then 4. B: two cells a thread where the block has four rows or
  // more (a tap row read serves both), else one (more threads at work).
  const bool pairs = rows >= 4 && rows % 2 == 0;
  if (pairs) blk.green<kImageOut, 2>();
  else blk.green<kImageOut, 1>();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (pairs) blk.blue<kImageOut, 2>();
  else blk.blue<kImageOut, 1>();
}

// Launches the tail on `stream` over row groups of `rows` cell rows (rows
// divides hh); returns the CUDA error code (0 = launched).
template <bool kImageOut>
inline int launch_tail(const float* trunk, const float* tg, const float* tb, float* out, int batch, int hh,
                       int ww, int rows, cudaStream_t stream) {
  if (rows < 1 || hh % rows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (kTgFloats + kTbFloats + static_cast<size_t>(2 * kPair) * (rows + kMapRows) * (ww + 2)) * sizeof(float);
  const cudaError_t err = allow_dynamic_smem<rgb_beta_tail_kernel<kImageOut>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rgb_beta_tail_kernel<kImageOut><<<batch * (hh / rows), kTailThreads, smem, stream>>>(trunk, tg, tb, out, hh,
                                                                                          ww, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace npe
