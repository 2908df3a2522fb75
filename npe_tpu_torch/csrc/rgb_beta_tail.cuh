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
// bfloat16. npe_tpu's kernel is dtype-generic: given bf16 it multiplies bf16
// operands, adds in float32 and rounds at fixed points. The bf16 form here is
// the same code over templates (T, the taps' and the output's type; TTrunk,
// the trunk's): the trunk is widened on load (bf16 from the hybrid head's
// library conv, or float32 from the fused head's trunk, which npe_tpu never
// rounds); the taps are widened into the same float32 tap planes in shared
// memory (exact), by ordinary loads where the float32 form has cp.async; R and
// G are rounded to bf16 where they enter the maps, which feed only the tap
// products, so the red Beta mean is taken from R recomputed unrounded from the
// trunk; every sum, sigmoid and Beta mean is float32, and the output is
// rounded to bf16. (npe_tpu/ops/pallas/mdcl_kernels.py `_beta_tail_kernel`:
// `pad1` rounds R and [R, G] before the products, nothing else.)
//
// Left for a later change: a TMA copy of the taps (multicast to the blocks of
// an image in a cluster), and splitting a cell's 8 sums over more threads.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
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
template <typename TTrunk, typename T>
struct TailBlock {
  const TTrunk* trunk_n;  // (6 rr, hh, ww) of this image
  T* out;
  float* maps;           // 4 rr planes of (rows + 5) x (ww + 2); map row r is cell row i0 - 2 + r
  const float* tg_s;
  const float* tb_s;
  int n, hh, ww, rows, i0, pw, plane;

  __device__ float pre(int ch, int cell) const { return to_f32(trunk_n[ch * hh * ww + cell]); }

  template <bool kImageOut>
  __device__ void store(int colour, int pos, int i, int j, float v) const {
    if (kImageOut) {
      const int y = 4 * i + pos / 4, x = 4 * j + pos % 4;
      out[(static_cast<size_t>(n * 3 + colour) * (4 * hh) + y) * (4 * ww) + x] = from_f32<T>(v);
    } else {
      out[(static_cast<size_t>(n * 3 + colour) * kRR + pos) * hh * ww + i * ww + j] = from_f32<T>(v);
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
      for (int k = 0; k < 8; ++k) centre[((k / 4) * kRR + 4 * g + k % 4) * plane] = round_to<T>(sigmoid_f32(v[k]));
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
          centre[(kPair + pos) * plane] = round_to<T>(a);
          centre[(kPair + kRR + pos) * plane] = round_to<T>(b);
          if (own) {
            // the red Beta mean of unrounded R: the maps hold it as it is in
            // float32, and rounded to bf16 in the bf16 form
            if constexpr (std::is_same_v<T, float>)
              store<kImageOut>(0, pos, row, j, beta_mean_f32(centre[pos * plane], centre[(kRR + pos) * plane]));
            else
              store<kImageOut>(0, pos, row, j, beta_mean_f32(sigmoid_f32(pre(pos, cell)), sigmoid_f32(pre(kRR + pos, cell))));
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

// The taps (n values, a multiple of 8) into float32 planes in shared memory:
// float32 by 16-byte cp.async, in the caller's commit group; bf16 widened by
// ordinary 16-byte loads.
template <typename T>
__device__ __forceinline__ void stage_taps(float* dst, const T* __restrict__ src, int n) {
  if constexpr (std::is_same_v<T, float>) {
    for (int idx = threadIdx.x; idx < n / 4; idx += blockDim.x) tail_cp_async16(dst + 4 * idx, src + 4 * idx);
  } else {
    for (int idx = threadIdx.x; idx < n / 8; idx += blockDim.x) {
      float v[8];
      bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(src) + idx), v);
      reinterpret_cast<float4*>(dst)[2 * idx] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[2 * idx + 1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// trunk: (batch, 6*rr, hh, ww). out: (batch, 3*rr, hh, ww), or with kImageOut
// the image itself, (batch, 3, 4*hh, 4*ww). Block b is image b / (hh / rows),
// cell rows rows * (b % (hh / rows)) onwards; rows divides hh. T is float
// (the float32 form) or __nv_bfloat16 (the bf16 form); TTrunk is T or float.
template <typename TTrunk, typename T, bool kImageOut>
__global__ void __launch_bounds__(kTailThreads)
rgb_beta_tail_kernel(const TTrunk* __restrict__ trunk, const T* __restrict__ tg, const T* __restrict__ tb,
                     T* __restrict__ out, int hh, int ww, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* tg_s = smem;
  float* tb_s = tg_s + kTgFloats;
  float* maps = tb_s + kTbFloats;  // 4*rr planes: R alpha, R beta, G alpha, G beta
  const int groups = hh / rows;
  const int n = blockIdx.x / groups;
  const int cells = hh * ww;
  const TailBlock<TTrunk, T> blk{trunk + static_cast<size_t>(n) * 6 * kRR * cells, out, maps, tg_s, tb_s, n, hh,
                                 ww, rows, static_cast<int>(blockIdx.x % groups) * rows, ww + 2,
                                 (rows + kMapRows) * (ww + 2)};

  // 1. Both tap tensors on their way into shared memory, tg in the first
  // group, tb in the second (in the bf16 form both are in place before the
  // barrier after the zeroing, and the groups are empty).
  stage_taps(tg_s, tg, kTgFloats);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_taps(tb_s, tb, kTbFloats);
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
  if (pairs) blk.template green<kImageOut, 2>();
  else blk.template green<kImageOut, 1>();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (pairs) blk.template blue<kImageOut, 2>();
  else blk.template blue<kImageOut, 1>();
}

// Launches the tail on `stream` over row groups of `rows` cell rows (rows
// divides hh); returns the CUDA error code (0 = launched).
template <bool kImageOut, typename TTrunk, typename T>
inline int launch_tail(const TTrunk* trunk, const T* tg, const T* tb, T* out, int batch, int hh, int ww,
                       int rows, cudaStream_t stream) {
  if (rows < 1 || hh % rows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (kTgFloats + kTbFloats + static_cast<size_t>(2 * kPair) * (rows + kMapRows) * (ww + 2)) * sizeof(float);
  const cudaError_t err = allow_dynamic_smem<rgb_beta_tail_kernel<TTrunk, T, kImageOut>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rgb_beta_tail_kernel<TTrunk, T, kImageOut><<<batch * (hh / rows), kTailThreads, smem, stream>>>(
      trunk, tg, tb, out, hh, ww, rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward: npe_tpu's `_tail_bwd` (mdcl_kernels.py), the VJP of
// `rgb_beta_tail_reference`, for a cotangent g of the output. Per cell, with
// dbeta the Beta mean's derivative and s(1 - s) the sigmoid's:
//   u_B        = dbeta(B) g_B * B(1 - B)                    dT_B = u_B
//   (dr_B, dg_B) = B^T(u_B) = sum_t shift_-t(u_B) @ tb[t]^T   32 -> 64
//   u_G        = (dbeta(G) g_G + dg_B) * G(1 - G)             dT_G = u_G
//   dT_R       = (dbeta(R) g_R + dr_B + G^T(u_G)) * R(1 - R)
//   dtb[t]     = sum over cells of shift_t([R, G])^T u_B,  dtg[t] = shift_t(R)^T u_G
// The chain is long: u_B at a cell needs B there, so R two cells away; dT_R
// needs u_G one cell away, so u_B two away, so R four away. Two designs were
// weighed: the forward's halo recompute with a halo of four rows (R and G
// recomputed on up to nine rows around a one-row block, the B product on
// five, each pass behind the one before it in one block), or passes that
// leave their results in device memory for the next, each with a halo of one
// row. The passes are taken: their intermediates are small (192 float32
// planes, 196 KB an image, L2-resident up to a batch of about 200), each pass
// is one tap product over a map staged with its one-row halo, the same code
// four times, where the halo recompute would multiply the dominant B product
// by five at one row a block (the grid of one image) and tie every pass's
// shared memory to nine map rows. Four launches a call (three when the trunk
// needs no gradient), six with the taps' gradients:
//   1. green:  R (rounded where it enters the products) on the rows +-1 from
//      the trunk, G's product; writes [R, G] rounded and G unrounded;
//   2. blue:   B's product over [R, G] +-1; writes u_B and dT_B;
//   3. blue_t: B^T over u_B +-1 (the mirrored taps transposed as they are
//      staged); dr_B and dg_B rounded where the bf16 VJP rounds; writes
//      dr_B, u_G and dT_G;
//   4. red:    G^T over u_G +-1; writes dT_R (R recomputed unrounded);
//   5. taps:   per block partial sums of dtb and dtg over its own cells;
//   6. taps_sum: the blocks' partial sums added in block order, rounded to
//      the taps' type. No atomics: the result is the same on every run.
// The grid of passes 1-5 is the forward's: batch x row groups of `rows`.
// What the first form of these passes taught (PERF.md; times from
// scripts/rgb_beta_bwd_passes.py): a block that staged its taps and map by
// loads whose stores waited on them, one row trip at a time, spent most of a
// pass there (16-28 us a pass at one image); so every copy is a cp.async in
// flight at once (the transposed taps: 16-byte loads, four a thread in
// flight). A block of one cell row has 64 or 128 items of eight outputs:
// `split` lanes share one, each over every split-th input plane, and add by
// butterfly shuffles in a fixed order. Pass 5 first read planar maps with
// four-way bank conflicts and stored one float a sector; it reads cell-major
// rows and stores each item's 32 sums as whole lines.
// Bound: operations, about 21.2 M multiply-adds an image (the forward again
// 7.08 M, B^T 4.72 M, G^T 2.36 M, dtb 4.72 M, dtg 2.36 M).
//
// bfloat16 (T = __nv_bfloat16; the trunk bf16, or float32 under the fused
// head) rounds where the bf16 VJP of `rgb_beta_tail_reference` does: R and
// [R, G] as they enter the products (the forward's points); the cotangents
// that come back through those rounded inputs (B^T's 64 sums, G^T's 32) to
// bf16; dtg and dtb summed in float32, then rounded; dT to the trunk's type.
// Everything else is float32, fused multiply-adds in the order tap, then
// channel.

constexpr int kBwdThreads = 512;
constexpr int kMaxSplit = 8;  // lanes that share one output's sums over the input planes, at most
// the scratch planes an image, float32: [R, G] rounded (64), G (32), u_B
// (32), u_G (32), dr_B (32)
constexpr int kScrRG = 0, kScrG = 2 * kPair, kScrUB = 3 * kPair, kScrUG = 4 * kPair, kScrDrB = 5 * kPair;
constexpr int kScratchPlanes = 6 * kPair;
// the taps' gradients a block sums: dtb (9, 64, 32), then dtg (9, 32, 32)
constexpr int kTapGrads = kTbFloats + kTgFloats;

template <typename TTrunk, typename T>
struct TailBwdArgs {
  const T* g;          // cotangent (batch, 3 rr, hh, ww); with kImage the image (batch, 3, 4 hh, 4 ww)
  const TTrunk* trunk;  // (batch, 6 rr, hh, ww)
  const T* tg;
  const T* tb;
  float* scratch;  // (batch, kScratchPlanes, hh, ww)
  TTrunk* dtrunk;  // (batch, 6 rr, hh, ww)
  float* partial;  // (blocks, kTapGrads)
  T* dtg;
  T* dtb;
  int hh, ww, rows;
};

// (d alpha, d beta) of the Beta mean 2 a / (a + b + 1e-8) - 1 for the
// cotangent go, in the order torch's autograd forms them.
__device__ __forceinline__ void beta_mean_vjp(float a, float b, float go, float& da, float& db) {
  const float g2 = 2.0f * go, s = a + b + 1e-8f;
  const float gs = -g2 * a / (s * s);
  da = g2 / s + gs;
  db = gs;
}

__device__ __forceinline__ float sigmoid_vjp(float y, float go) { return go * (1.0f - y) * y; }

__device__ __forceinline__ void bwd_cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Sixteen bytes of T from global memory as float32 values.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, float (&v)[16 / sizeof(T)]) {
  if constexpr (std::is_same_v<T, float>) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(src)), v);
  }
}

// The taps a pass multiplies by, (9, kIn, kOut) rows of kOut + 4 floats in
// shared memory (the pad puts the rows that the lanes of a split read at
// once in different banks): passes 1 and 2 the forward's taps as they lie,
// float32 by 16-byte cp.async; passes 3 and 4 tap t the mirrored tap 8 - t
// transposed, from 16-byte loads of its rows, neighbouring threads on
// neighbouring output planes (so their shared-memory stores do not collide).
template <int kPass, typename T>
__device__ __forceinline__ void stage_bwd_taps(float* dst, const T* __restrict__ src) {
  constexpr int kIn = kPass == 2 ? 2 * kPair : kPair, kOut = kPass == 3 ? 2 * kPair : kPair, kRow = kOut + 4;
  constexpr int kV = 16 / sizeof(T);
  if constexpr (kPass <= 2) {
#pragma unroll 4
    for (int c = threadIdx.x; c < 9 * kIn * kOut / kV; c += blockDim.x) {
      float* d = dst + (c / (kOut / kV)) * kRow + (c % (kOut / kV)) * kV;
      if constexpr (std::is_same_v<T, float>) {
        tail_cp_async16(d, src + c * kV);
      } else {
        float v[kV];
        load16(src + c * kV, v);
#pragma unroll
        for (int q = 0; q < kV; ++q) d[q] = v[q];
      }
    }
  } else {  // src is (9, kOut, kIn): the forward's taps of the product this pass transposes
#pragma unroll 4
    for (int c = threadIdx.x; c < 9 * kOut * kIn / kV; c += blockDim.x) {
      const int o = c % kOut, iq = (c / kOut) % (kIn / kV), t = c / (kOut * (kIn / kV));
      float v[kV];
      load16(src + (t * kOut + o) * kIn + iq * kV, v);
#pragma unroll
      for (int q = 0; q < kV; ++q) dst[((8 - t) * kIn + iq * kV + q) * kRow + o] = v[q];
    }
  }
}

// The pass `kPass` (1 green, 2 blue, 3 blue_t, 4 red) for one block: the
// block's cell rows i0 .. i0 + rows - 1 of image n. Its input map (kIn
// planes: R, [R, G], u_B or u_G) is staged with a zero border and one row
// either side (from the scratch by 4-byte cp.async, every copy in flight;
// pass 1 computes R from the trunk), its taps by `stage_bwd_taps`. A work
// item is eight outputs of one cell: a colour's positions 4q .. 4q + 3 in
// alpha and in beta, as the forward's threads own them, so the item can form
// the Beta mean's derivative itself. Where a block has few items (one or two
// cell rows: a small batch) `split` neighbouring lanes share an item, each
// summing every split-th input plane, and add their sums by butterfly
// shuffles in a fixed order: the chain of dependent sums a thread follows is
// `split` times shorter.
template <int kPass, typename TTrunk, typename T, bool kImage>
__device__ __forceinline__ void tail_bwd_pass(const TailBwdArgs<TTrunk, T>& a) {
  constexpr int kIn = kPass == 2 ? 2 * kPair : kPair;
  constexpr int kOut = kPass == 3 ? 2 * kPair : kPair;
  constexpr int kRow = kOut + 4;
  extern __shared__ __align__(16) float smem[];
  float* taps = smem;
  float* map = smem + 9 * kIn * kRow;
  const int groups = a.hh / a.rows, n = blockIdx.x / groups, i0 = (blockIdx.x % groups) * a.rows;
  const int cells = a.hh * a.ww, pw = a.ww + 2, plane = (a.rows + 2) * pw;
  const TTrunk* trunk = a.trunk + static_cast<size_t>(n) * 6 * kRR * cells;
  float* scr = a.scratch + static_cast<size_t>(n) * kScratchPlanes * cells;
  TTrunk* dtrunk = a.dtrunk + static_cast<size_t>(n) * 6 * kRR * cells;

  for (int idx = threadIdx.x; idx < kIn * plane; idx += blockDim.x) map[idx] = 0.0f;
  stage_bwd_taps<kPass>(taps, (kPass == 1 || kPass == 4) ? a.tg : a.tb);
  __syncthreads();  // the zeros are in before the copies land
  // the input map on the rows i0 - 1 .. i0 + rows inside the image
  const int lo = max(i0 - 1, 0), n_rows = min(i0 + a.rows + 1, a.hh) - lo;
  const int in_plane = kPass == 2 ? kScrRG : kPass == 3 ? kScrUB : kScrUG;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kIn * n_rows * a.ww; idx += blockDim.x) {
    const int j = idx % a.ww, row = lo + (idx / a.ww) % n_rows, ci = idx / (a.ww * n_rows);
    const int cell = row * a.ww + j;
    float* d = map + ci * plane + (row - i0 + 1) * pw + j + 1;
    if constexpr (kPass == 1) *d = round_to<T>(sigmoid_f32(to_f32(trunk[ci * cells + cell])));
    else bwd_cp_async4(d, scr + (in_plane + ci) * cells + cell);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  auto go = [&](int colour, int pos, int row, int j) {
    if constexpr (kImage)
      return to_f32(a.g[(static_cast<size_t>(n * 3 + colour) * (4 * a.hh) + 4 * row + pos / 4) * (4 * a.ww) +
                        4 * j + pos % 4]);
    else
      return to_f32(a.g[(static_cast<size_t>(n) * 3 * kRR + colour * kRR + pos) * cells + row * a.ww + j]);
  };

  const int n_items = (kOut / 8) * a.rows * a.ww;
  int split = 1;  // the same in every thread of the block
  while (split < kMaxSplit && 2 * split * n_items <= static_cast<int>(blockDim.x)) split *= 2;
  const int total = split * n_items;
  // every thread runs every round, so each split's lanes shuffle together;
  // a lane past the end redoes the last item and stores nothing
  for (int it0 = 0; it0 < total; it0 += blockDim.x) {
    const int it = min(it0 + static_cast<int>(threadIdx.x), total - 1);
    const int lane = it % split, item = it / split;
    const int j = item % a.ww, r = (item / a.ww) % a.rows, grp = item / (a.ww * a.rows);
    const int base = (grp / 4) * kPair + 4 * (grp % 4);  // alpha planes base .. base + 3, beta base + rr ..
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    for (int t = 0; t < 9; ++t) {
      const float* at = map + (r + t / 3) * pw + j + t % 3;
      const float* w = taps + t * kIn * kRow + base;
#pragma unroll 4
      for (int ci = lane; ci < kIn; ci += split) {
        const float v = at[ci * plane];
        const float4 wa = *reinterpret_cast<const float4*>(w + ci * kRow);
        const float4 wb = *reinterpret_cast<const float4*>(w + ci * kRow + kRR);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(v, wv[k], acc[k]);
      }
    }
    for (int m = 1; m < split; m *= 2)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], m);
    if (lane != 0 || it0 + static_cast<int>(threadIdx.x) >= total) continue;
    const int row = i0 + r, cell = row * a.ww + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pos = 4 * (grp % 4) + k;
      if constexpr (kPass == 1) {  // [R, G] rounded, G unrounded
        const float ga = sigmoid_f32(to_f32(trunk[(kPair + pos) * cells + cell]) + acc[k]);
        const float gb = sigmoid_f32(to_f32(trunk[(kPair + kRR + pos) * cells + cell]) + acc[4 + k]);
        scr[(kScrRG + pos) * cells + cell] = map[pos * plane + (r + 1) * pw + j + 1];
        scr[(kScrRG + kRR + pos) * cells + cell] = map[(kRR + pos) * plane + (r + 1) * pw + j + 1];
        scr[(kScrRG + kPair + pos) * cells + cell] = round_to<T>(ga);
        scr[(kScrRG + kPair + kRR + pos) * cells + cell] = round_to<T>(gb);
        scr[(kScrG + pos) * cells + cell] = ga;
        scr[(kScrG + kRR + pos) * cells + cell] = gb;
      } else if constexpr (kPass == 2) {  // u_B and dT_B
        const float ba = sigmoid_f32(to_f32(trunk[(2 * kPair + pos) * cells + cell]) + acc[k]);
        const float bb = sigmoid_f32(to_f32(trunk[(2 * kPair + kRR + pos) * cells + cell]) + acc[4 + k]);
        float da, db;
        beta_mean_vjp(ba, bb, go(2, pos, row, j), da, db);
        const float ua = sigmoid_vjp(ba, da), ub = sigmoid_vjp(bb, db);
        scr[(kScrUB + pos) * cells + cell] = ua;
        scr[(kScrUB + kRR + pos) * cells + cell] = ub;
        dtrunk[(2 * kPair + pos) * cells + cell] = from_f32<TTrunk>(ua);
        dtrunk[(2 * kPair + kRR + pos) * cells + cell] = from_f32<TTrunk>(ub);
      } else if constexpr (kPass == 3) {  // B^T: dr_B kept; u_G and dT_G
        const float d_a = round_to<T>(acc[k]), d_b = round_to<T>(acc[4 + k]);  // dr_B or dg_B
        if (grp < 4) {
          scr[(kScrDrB + pos) * cells + cell] = d_a;
          scr[(kScrDrB + kRR + pos) * cells + cell] = d_b;
        } else {
          const float ga = scr[(kScrG + pos) * cells + cell], gb = scr[(kScrG + kRR + pos) * cells + cell];
          float da, db;
          beta_mean_vjp(ga, gb, go(1, pos, row, j), da, db);
          const float ua = sigmoid_vjp(ga, da + d_a), ub = sigmoid_vjp(gb, db + d_b);
          scr[(kScrUG + pos) * cells + cell] = ua;
          scr[(kScrUG + kRR + pos) * cells + cell] = ub;
          dtrunk[(kPair + pos) * cells + cell] = from_f32<TTrunk>(ua);
          dtrunk[(kPair + kRR + pos) * cells + cell] = from_f32<TTrunk>(ub);
        }
      } else {  // G^T: dT_R
        const float ra = sigmoid_f32(to_f32(trunk[pos * cells + cell]));
        const float rb = sigmoid_f32(to_f32(trunk[(kRR + pos) * cells + cell]));
        float da, db;
        beta_mean_vjp(ra, rb, go(0, pos, row, j), da, db);
        da += scr[(kScrDrB + pos) * cells + cell];
        db += scr[(kScrDrB + kRR + pos) * cells + cell];
        dtrunk[pos * cells + cell] = from_f32<TTrunk>(sigmoid_vjp(ra, da + round_to<T>(acc[k])));
        dtrunk[(kRR + pos) * cells + cell] = from_f32<TTrunk>(sigmoid_vjp(rb, db + round_to<T>(acc[4 + k])));
      }
    }
  }
}

template <typename TTrunk, typename T, bool kImage>
__global__ void __launch_bounds__(kBwdThreads) tail_bwd_green_kernel(TailBwdArgs<TTrunk, T> a) {
  tail_bwd_pass<1, TTrunk, T, kImage>(a);
}
template <typename TTrunk, typename T, bool kImage>
__global__ void __launch_bounds__(kBwdThreads) tail_bwd_blue_kernel(TailBwdArgs<TTrunk, T> a) {
  tail_bwd_pass<2, TTrunk, T, kImage>(a);
}
template <typename TTrunk, typename T, bool kImage>
__global__ void __launch_bounds__(kBwdThreads) tail_bwd_blue_t_kernel(TailBwdArgs<TTrunk, T> a) {
  tail_bwd_pass<3, TTrunk, T, kImage>(a);
}
template <typename TTrunk, typename T, bool kImage>
__global__ void __launch_bounds__(kBwdThreads) tail_bwd_red_kernel(TailBwdArgs<TTrunk, T> a) {
  tail_bwd_pass<4, TTrunk, T, kImage>(a);
}

// Pass 5: the block's partial sums of dtb and dtg over its own cells, from
// [R, G] (rounded, with its one-row halo and a zero border) and u_B, u_G on
// its rows, both staged cell-major (a cell's 64 planes together, rows of 68
// floats so that neighbouring cells start in other banks) by 4-byte
// cp.async. A work item is one tap's 4 input planes by 8 output planes, 32
// sums in registers: 9 x 16 x 4 of dtb, 9 x 8 x 4 of dtg. A warp's lanes
// take one tap's neighbouring items, so per cell it reads one 128-byte line
// of [R, G] and one of u with each of its three 16-byte loads. An item's 32
// sums are stored together (`tap_grad_index` says where each lands), so a
// warp's stores are whole lines.
constexpr int kTbItems = 9 * (2 * kPair / 4) * (kPair / 8), kTgItems = 9 * (kPair / 4) * (kPair / 8);

// Where dtb's (t, i, o) (tb) or dtg's lies in a block's partial sums.
__device__ __forceinline__ int tap_grad_index(bool tb, int t, int i, int o) {
  const int n_in = tb ? 2 * kPair : kPair;
  const int item = (tb ? 0 : kTbItems) + (t * (n_in / 4) + i / 4) * 4 + o / 8;
  return item * 32 + (i % 4) * 8 + o % 8;
}

template <typename TTrunk, typename T>
__global__ void __launch_bounds__(kBwdThreads) tail_bwd_taps_kernel(TailBwdArgs<TTrunk, T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kC = 2 * kPair + 4;  // floats a cell: [R, G], or u_B then u_G; and a pad
  const int groups = a.hh / a.rows, n = blockIdx.x / groups, i0 = (blockIdx.x % groups) * a.rows;
  const int cells = a.hh * a.ww, pw = a.ww + 2, own = a.rows * a.ww;
  float* map = smem;                          // (rows + 2) x (ww + 2) cells of kC
  float* u = smem + (a.rows + 2) * pw * kC;  // own cells of kC
  const float* scr = a.scratch + static_cast<size_t>(n) * kScratchPlanes * cells;
  for (int idx = threadIdx.x; idx < (a.rows + 2) * pw * kC; idx += blockDim.x) map[idx] = 0.0f;
  __syncthreads();
  const int lo = max(i0 - 1, 0), n_rows = min(i0 + a.rows + 1, a.hh) - lo;
  for (int idx = threadIdx.x; idx < 2 * kPair * n_rows * a.ww; idx += blockDim.x) {
    const int j = idx % a.ww, row = lo + (idx / a.ww) % n_rows, ci = idx / (a.ww * n_rows);
    bwd_cp_async4(map + ((row - i0 + 1) * pw + j + 1) * kC + ci, scr + (kScrRG + ci) * cells + row * a.ww + j);
  }
  for (int idx = threadIdx.x; idx < 2 * kPair * own; idx += blockDim.x) {
    const int c = idx % own, o = idx / own;  // scratch planes kScrUB .. kScrUG + 31 are contiguous
    bwd_cp_async4(u + c * kC + o, scr + (kScrUB + o) * cells + i0 * a.ww + c);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float* part = a.partial + static_cast<size_t>(blockIdx.x) * kTapGrads;
  for (int it = threadIdx.x; it < kTbItems + kTgItems; it += blockDim.x) {
    const bool tb = it < kTbItems;
    const int e = tb ? it : it - kTbItems, n_in = tb ? 2 * kPair : kPair;
    const int t = e / ((n_in / 4) * 4), iq = (e / 4) % (n_in / 4), oc = e % 4;
    const float* h = map + ((t / 3) * pw + t % 3) * kC + 4 * iq;
    const float* uu = u + (tb ? 0 : kPair) + 8 * oc;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[i][o] = 0.0f;
    for (int r = 0; r < a.rows; ++r) {
      const float* hr = h + r * pw * kC;
      const float* ur = uu + r * a.ww * kC;
#pragma unroll 2
      for (int j = 0; j < a.ww; ++j) {
        const float4 hv = *reinterpret_cast<const float4*>(hr + j * kC);
        const float4 ua = *reinterpret_cast<const float4*>(ur + j * kC);
        const float4 ub = *reinterpret_cast<const float4*>(ur + j * kC + 4);
        const float hs[4] = {hv.x, hv.y, hv.z, hv.w}, us[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[i][o] = fmaf(hs[i], us[o], acc[i][o]);
      }
    }
    float4* dst = reinterpret_cast<float4*>(part + it * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[2 * i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      dst[2 * i + 1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// Pass 6: dtb and dtg, the blocks' partial sums added in block order.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
tail_bwd_taps_sum_kernel(const float* __restrict__ partial, int blocks, T* __restrict__ dtb, T* __restrict__ dtg) {
  const int i = blockIdx.x * kBwdThreads + threadIdx.x;
  if (i >= kTapGrads) return;
  const bool tb = i < kTbFloats;
  const int e = tb ? i : i - kTbFloats, n_in = tb ? 2 * kPair : kPair;  // e = (t * n_in + in) * 32 + out
  const int at = tap_grad_index(tb, e / (n_in * kPair), (e / kPair) % n_in, e % kPair);
  float s = partial[at];
  for (int b = 1; b < blocks; ++b) s += partial[static_cast<size_t>(b) * kTapGrads + at];
  if (tb) dtb[e] = from_f32<T>(s);
  else dtg[e] = from_f32<T>(s);
}

// Shared memory of a backward pass's block (floats): its padded taps and
// map, or pass 5's map and own cells.
inline size_t tail_bwd_pass_smem(int pass, int ww, int rows) {
  const size_t plane = static_cast<size_t>(rows + 2) * (ww + 2);
  if (pass == 5) return (2 * kPair + 4) * (plane + static_cast<size_t>(rows) * ww) * sizeof(float);
  const int n_in = pass == 2 ? 2 * kPair : kPair, n_out = pass == 3 ? 2 * kPair : kPair;
  return (9 * n_in * (n_out + 4) + n_in * plane) * sizeof(float);
}

template <auto kKernel, typename Args>
inline int launch_bwd_pass(const Args& a, int blocks, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_dynamic_smem<kKernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kKernel<<<blocks, kBwdThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward's launches on `stream` over the forward's row groups (`rows`
// divides hh): dT (the trunk's type) where need_trunk (dT_B and dT_G are
// written either way), and dtg, dtb where need_taps (then `partial` holds
// batch * hh / rows * kTapGrads floats). Returns the first CUDA error (0 = all
// launched).
template <bool kImage, typename TTrunk, typename T>
inline int launch_tail_bwd(const TailBwdArgs<TTrunk, T>& a, int batch, int need_trunk, int need_taps,
                           cudaStream_t stream) {
  if (a.rows < 1 || a.hh % a.rows) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = batch * (a.hh / a.rows);
  int err = launch_bwd_pass<tail_bwd_green_kernel<TTrunk, T, kImage>>(a, blocks, tail_bwd_pass_smem(1, a.ww, a.rows),
                                                                       stream);
  if (err == 0)
    err = launch_bwd_pass<tail_bwd_blue_kernel<TTrunk, T, kImage>>(a, blocks, tail_bwd_pass_smem(2, a.ww, a.rows),
                                                                    stream);
  if (err == 0)
    err = launch_bwd_pass<tail_bwd_blue_t_kernel<TTrunk, T, kImage>>(a, blocks, tail_bwd_pass_smem(3, a.ww, a.rows),
                                                                      stream);
  if (err == 0 && need_trunk)
    err = launch_bwd_pass<tail_bwd_red_kernel<TTrunk, T, kImage>>(a, blocks, tail_bwd_pass_smem(4, a.ww, a.rows),
                                                                   stream);
  if (err != 0 || !need_taps) return err;
  err = launch_bwd_pass<tail_bwd_taps_kernel<TTrunk, T>>(a, blocks, tail_bwd_pass_smem(5, a.ww, a.rows), stream);
  if (err != 0) return err;
  tail_bwd_taps_sum_kernel<T><<<(kTapGrads + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0, stream>>>(
      a.partial, blocks, a.dtb, a.dtg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace npe
