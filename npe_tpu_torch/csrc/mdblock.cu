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
// tap tensors). On the tensor cores in TF32 (495 TFLOP/s) at three products
// per multiply-add (below) the operations take 11 us at 16x16x256 and
// 32x32x128, and at 8x8x512 the 38 MB of taps at 3.35 TB/s bound it instead
// (11.35 us); at batch 128 the operations, 0.94 / 1.41 / 1.41 ms a block.
// PERF.md has the bounds and the measured times.
//
// Accuracy: 3xTF32. One TF32 product keeps 10 mantissa bits per operand and
// misses float32 by about 1e-3 relative on these 9,216-term sums, more than
// the port's parity allows. So every operand is split, v = hi + lo with
// hi = tf32(v) and lo = tf32(v - hi) (cvt.rna, round to nearest, ties away),
// and each tile product is lo*hi + hi*lo + hi*hi, the small terms first, into
// float32 accumulators: float32 accuracy (lo*lo, about 2^-22 relative, is
// dropped). tests/test_torch_mdblock.py emulates both on the CPU. One thing
// the emulation does not show: the tensor cores add their products and the
// sum they are given with truncation, so a sum carried in the accumulators
// over all 108 to 288 steps drifts toward zero by about one float32 rounding
// per product; each step (a tap by 32 input channels) therefore starts from
// zero and is added to the running sums by an ordinary float32 add.
//
// Design, in the order the work goes (mdblock_bwd.cu's, on the forward's
// operands):
// 1. The prologue (mdcl_kernel<0>) reads x (NCHW) and writes MDCL1's input
//    lrelu(s0 * x + t0) pixel-major (NHWC) as a TF32 operand pair, hi and
//    lo, the lo images after the hi. MDCL1's epilogue writes
//    h1 = lrelu(s1 * MDCL1 + t1) as the same pair, MDCL2's operand, and,
//    where x will need a gradient, h1 float32 NCHW for the backward.
//    MDCL2's epilogue adds the raw x and writes y NCHW.
// 2. Each MDCL (mdcl_kernel<1, kSub>, mdcl_kernel<2, kSub>) is one kernel of
//    two 128-thread consumer warpgroups and a producer warp over a tile of
//    kSub 8x8 patches by 128 output channels. A unit is (chunk, tap), a
//    chunk 32 input channels. The producer's one thread arms a stage's
//    mbarrier and asks the tensor memory accelerator for the tap tile, rows
//    ci of the chunk by the tile's columns co of taps[t] as they lie, and,
//    when u starts a chunk or the slice, for each patch's halo tiles: one box of
//    (8 + 2R)^2 pixels by the chunk's channels of the pair's hi image and
//    one of its lo image (R the largest dilation; zeros outside the image
//    and past C). Every tap of every branch reads its shifted 8x8 window of
//    those tiles by the wgmma descriptor alone. Where two halo buffers and
//    three stages do not fit (a dilation past 4), a stage brings each unit's
//    own shifted 8x8 window pair instead (`fwd_plan`'s `halo`).
// 3. The stages are a ring released by mbarriers, as in mdblock_bwd.cu: the
//    producer runs as far ahead as the ring allows. One patch a block
//    (kSub 1, batch 1 to 16 at full IAN's shapes): the two consumer
//    warpgroups take alternate units of the slice over the same ring and
//    halo tiles, each with its own running sums, which are added (the first
//    warpgroup's, then the second's) before the epilogue; one warpgroup
//    alone was bound by its own instructions (the split, the sums' adds, the
//    barriers): without its products it took 1.88 of its 2.68 ms at 8x8x512
//    batch 128. Two patches a block (kSub 2, once the batch gives every SM
//    two tiles): each warpgroup takes its own patch over every unit and
//    splits half of each tap tile, so that a tap tile serves 128 pixels;
//    with one patch a block the tap tiles' reads from L2 (16 KB a unit for
//    64 pixels, 2.4 to 3.6 GB a block of full IAN at batch 128) bound it:
//    without its products it still took 1.67 / 2.50 / 2.84 ms. Two patches'
//    halo tiles fit one buffer each; they complete on a barrier of their own
//    so that the next unit's tap tile, which the consumers split before
//    they release the chunk's last unit, is copied ahead of them.
// 4. 3xTF32 wgmma m64n128k8. TF32 wgmma takes both operands K-major only;
//    the activations' tiles are (channels innermost), the taps' are not:
//    taps[t, ci, co] has co innermost. So the consumers split each tap tile
//    transposed: each thread reads one column co of the 32 x 128 tile (with
//    two patches, of half its rows) as it landed, and, once its warpgroup
//    has read them, writes the column's hi in place as K-major core matrices
//    and its lo beside them, while the tensor cores run the stage before.
//    Each stage is
//    lo*hi + hi*lo + hi*hi summed from zero, then added to the running sums.
// 5. Batch 1 (one patch a block): the output has 4 to 16 tiles for 132 SMs,
//    so the units are cut into slices over blockIdx.y, and the slices of a
//    tile run as a thread-block cluster of up to 8 blocks that adds them through
//    distributed shared memory in rank order (fixed order, no atomics: two
//    calls are bit-equal). Only where a tile has more slices than a cluster
//    holds does add_slices_kernel add the clusters' sums in order.
// 6. Launches after the prologue use programmatic dependent launch.
// A call is 3 launches (prologue, MDCL1, MDCL2), or 5 where the plan's
// slices outnumber a cluster; `fwd_plan` in
// npe_tpu_torch/ops/kernels/mdblock.py states the rule.
//
// Rounding points: the operand split alone, as the earlier mma.sync form of
// this kernel rounded (x after BN0's affine and lrelu, h1 after BN1's, and
// the taps, each into its TF32 pair); the sums, affines and the residual are
// float32.
//
// This file is the float32 form. The bf16 form is mdblock_bf16.cu; x's
// gradient (npe_tpu's `_fused_bwd`) is mdblock_bwd.cu's.

#include <cuda_runtime.h>

#include <cstdint>

#include "dynamic_smem.cuh"
#include "tma.cuh"

namespace {

using namespace npe;

constexpr int kTileP = 64;             // pixels of a patch (8x8): the warpgroup's M
constexpr int kN = 128;                // output channels of a tile: wgmma's N
constexpr int kGroups = 8;             // 16-byte channel groups of a chunk
constexpr int kChunk = 4 * kGroups;    // input channels of a unit
constexpr int kTapBytes = kChunk * kN * 4;     // a tap tile: 16 KB as it lands, as hi, as lo
constexpr int kStageBytes = 2 * kTapBytes;     // hi (where the tile lands), then lo
constexpr int kPartLd = kN + 4;        // floats a row of a staged partial tile
constexpr int kMaxBranches = 8;
constexpr int kMaxStages = 8;
constexpr int kThreads = 256;          // the prologue's and add_slices' blocks
constexpr int kConsumers = 2;          // consumer warpgroups of an MDCL block
constexpr int kMdclThreads = 128 * kConsumers + 32;  // and the producer warp

struct Branches {
  int n;
  int dilation[kMaxBranches];
};

// One MDCL launch.
struct Fwd {
  Branches branches;
  int batch, channels, height, width;
  int patches_x, patches;  // 8x8 patches a row of an image; in the batch
  int radius;              // the largest dilation
  int halo;                // 1: a halo tile a chunk; 0: a window pair a unit
  int units, splits, cluster, stages;
  float* out;              // pass 1: h1's pair (pixel-major); pass 2: y (NCHW)
  float* h1;               // pass 1: h1 NCHW for the backward, or null
  float* partial;          // splits > cluster: (batch, splits / cluster, ...) in the output's layout
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

// An operand pair: hi = tf32(v) at hi[0], lo = tf32(v - hi) at hi[lo_offset].
__device__ __forceinline__ void store_pair(float* hi, size_t lo_offset, float v) {
  const float h = tf32(v);
  hi[0] = h;
  hi[lo_offset] = tf32(v - h);
}

// The epilogue of a finished sum v of channel c at pixel pix of image img.
// pass 1: h1 = lrelu(s1 * v + t1) as its pair, and NCHW where asked;
// pass 2: y = lrelu(s2 * (x + v) + t2).
template <int kPass>
__device__ __forceinline__ void finish(const Fwd& p, const float* __restrict__ x, const float* __restrict__ aff,
                                       float v, size_t img, int pix, int c) {
  const int channels = p.channels, hw = p.height * p.width;
  const size_t nchw = (img * channels + c) * hw + pix;
  if constexpr (kPass == 1) {
    const float h = lrelu(fmaf(__ldg(aff + 2 * channels + c), v, __ldg(aff + 3 * channels + c)));
    store_pair(p.out + (img * hw + pix) * channels + c, static_cast<size_t>(p.batch) * hw * channels, h);
    if (p.h1 != nullptr) p.h1[nchw] = h;
  } else {
    p.out[nchw] = lrelu(fmaf(__ldg(aff + 4 * channels + c), v + __ldg(x + nchw), __ldg(aff + 5 * channels + c)));
  }
}

// Barrier `id` of `threads` threads (the consumer warpgroups).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The transposing TF32 split of a tap tile, or of kParts consecutive 16-byte
// groups of it: the tile lands as [32 ci][128 co] floats; thread t of a
// consumer warpgroup reads column co = t of rows 4 g0 .. 4 (g0 + kParts) - 1,
// and once the warpgroup has read them (barrier `id`) writes the column's
// hi over them as K-major core matrices, [ci / 4][co][ci % 4], and its lo
// kTapBytes on.
template <int kParts>
__device__ __forceinline__ void split_tile(uint8_t* tile, int t, int g0, int id) {
  const float* raw = reinterpret_cast<const float*>(tile) + 4 * g0 * kN;
  float v[4 * kParts];
#pragma unroll
  for (int k = 0; k < 4 * kParts; ++k) v[k] = raw[k * kN + t];
  named_sync(id, 128);  // the rows are read before hi overwrites them
#pragma unroll
  for (int g = 0; g < kParts; ++g) {
    const float4 hi = make_float4(tf32(v[4 * g]), tf32(v[4 * g + 1]), tf32(v[4 * g + 2]), tf32(v[4 * g + 3]));
    reinterpret_cast<float4*>(tile)[(g0 + g) * kN + t] = hi;
    reinterpret_cast<float4*>(tile + kTapBytes)[(g0 + g) * kN + t] =
        make_float4(tf32(v[4 * g] - hi.x), tf32(v[4 * g + 1] - hi.y), tf32(v[4 * g + 2] - hi.z),
                    tf32(v[4 * g + 3] - hi.w));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's reads
}

// MDCL1's input lrelu(s0 * x + t0) from x (NCHW), written pixel-major as its
// operand pair, the lo images after the hi; a block turns a 64-channel x
// 64-pixel tile of one image through shared memory.
__device__ __forceinline__ void prologue(const float* __restrict__ x, const float* __restrict__ aff,
                                         float* __restrict__ act, int channels, int hw) {
  launch_next();
  __shared__ float tile[64][kTileP + 1];  // [channel][pixel]
  const size_t lo = static_cast<size_t>(gridDim.z) * hw * channels;
  const int p0 = blockIdx.x * kTileP, c0 = blockIdx.y * 64;
  const size_t n = blockIdx.z;
  for (int i = threadIdx.x; i < 64 * kTileP / 4; i += kThreads) {
    const int c = i / (kTileP / 4), q = i % (kTileP / 4);
    if (c0 + c >= channels) continue;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + (n * channels + c0 + c) * hw + p0 + 4 * q));
    const float s = __ldg(aff + c0 + c), t = __ldg(aff + channels + c0 + c);
    tile[c][4 * q] = lrelu(fmaf(s, v.x, t));
    tile[c][4 * q + 1] = lrelu(fmaf(s, v.y, t));
    tile[c][4 * q + 2] = lrelu(fmaf(s, v.z, t));
    tile[c][4 * q + 3] = lrelu(fmaf(s, v.w, t));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * kTileP; i += kThreads) {
    const int px = i / 64, c = i % 64;
    if (c0 + c < channels) store_pair(act + (n * hw + p0 + px) * channels + c0 + c, lo, tile[c][px]);
  }
}

// One MDCL over the slice blockIdx.y of its units (the header's steps 2-5),
// or (kPass 0) the prologue. kSub: patches a block, one (the two consumer
// warpgroups on alternate units of its slice) or two (each warpgroup its own
// patch over all units, one slice, one halo buffer a patch). x: the block's
// input (pass 2: the residual); aff: (6, C), rows s0, t0, s1, t1, s2, t2;
// taps: the pass's tap tensor, which taps_map reads (null in the prologue);
// act_map reads the pass's operand pair.
template <int kPass, int kSub>
__global__ void __launch_bounds__(kPass == 0 ? kThreads : kMdclThreads, 1)
mdcl_kernel(const float* __restrict__ x, const float* __restrict__ aff, const float* __restrict__ taps,
            const __grid_constant__ Fwd p, const __grid_constant__ CUtensorMap taps_map,
            const __grid_constant__ CUtensorMap act_map) {
  if constexpr (kPass == 0) {
    prologue(x, aff, p.out, p.channels, p.height * p.width);
    return;
  } else {
    extern __shared__ __align__(128) uint8_t smem[];
    const int tid = threadIdx.x, wg = tid / 128;
    const int channels = p.channels, stages = p.stages;
    const int tiles_c = (channels + kN - 1) / kN;
    const int n0 = blockIdx.x % tiles_c * kN, group = blockIdx.x / tiles_c, split = blockIdx.y;
    const int n_taps = 9 * p.branches.n;
    const int first = static_cast<int>(static_cast<long long>(split) * p.units / p.splits);
    const int last = static_cast<int>(static_cast<long long>(split + 1) * p.units / p.splits);
    const int first_chunk = first / n_taps;
    // the activations' tiles a patch: a halo tile a chunk in two buffers (one
    // with two patches), or a window a unit in each stage
    const int reach = p.halo ? p.radius : 0, side = 8 + 2 * reach, act_px = side * side;
    const int act_bytes = act_px * 16 * kGroups, act_buffers = !p.halo ? stages : kSub == 2 ? 1 : 2;
    uint8_t* const taps_s = smem;
    uint8_t* const act_s = smem + stages * kStageBytes;  // [patch][buffer][hi, lo][act_bytes]
    const uint32_t full = smem_addr(act_s + kSub * act_buffers * 2 * act_bytes), empty = full + 8 * kMaxStages;
    // One halo buffer: the halo tiles complete on a barrier of their own (in
    // the slot that stages < kMaxStages leaves free), so that the next unit's
    // tap tile, which the consumers split before they release the chunk's
    // last unit, is not held back with them.
    const uint32_t halo_full = empty + 8 * (kMaxStages - 1);
    const bool own_halo_bar = p.halo && act_buffers == 1;
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) {
        barrier_init(full + 8 * i);
        barrier_init<kSub>(empty + 8 * i);  // a unit's consumers: one warpgroup, or both
      }
      if (own_halo_bar) barrier_init(halo_full);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Each patch of the block: its image and its top-left corner.
    int img[kSub], py0[kSub], px0[kSub];
    bool valid[kSub];
    const int per_image = p.patches / p.batch;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int idx = group * kSub + s, at = idx % per_image;
      valid[s] = idx < p.patches;
      img[s] = valid[s] ? idx / per_image : 0;
      py0[s] = 8 * (at / p.patches_x);
      px0[s] = 8 * (at % p.patches_x);
    }
    // the patch a consumer warpgroup's sums are of
    const bool mine = kSub == 2 && wg == 1;
    const int my_img = mine ? img[kSub - 1] : img[0];
    const int my_py0 = mine ? py0[kSub - 1] : py0[0], my_px0 = mine ? px0[kSub - 1] : px0[0];
    const bool my_valid = mine ? valid[kSub - 1] : valid[0];
    auto offset = [&](int t, int& dy, int& dx) {  // tap t's (dy, dx)
      const int dil = p.branches.dilation[t / 9];
      dy = (t % 9 / 3 - 1) * dil;
      dx = (t % 3 - 1) * dil;
    };

    float acc[kN / 2];
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) acc[e] = 0.0f;

    if (wg == kConsumers) {
      // The producer warp: its first thread issues every copy.
      if (tid == 128 * kConsumers) {
        bool waited = false;
        for (int u = first; u < last; ++u) {
          const int k = u - first, stage = k % stages;
          if (k >= stages) barrier_wait(empty + 8 * stage, (k / stages - 1) & 1);  // unit u - stages is done
          const int chunk = u / n_taps, t = u - chunk * n_taps;
          const bool act_load = !p.halo || t == 0 || u == first;
          int loaded = 0;
#pragma unroll
          for (int s = 0; s < kSub; ++s) loaded += act_load && valid[s];
          uint32_t bar = full + 8 * stage;
          barrier_expect(bar, kTapBytes + (own_halo_bar ? 0 : loaded * 2 * act_bytes));
          // (the tile's 128 columns co, the chunk's 32 rows ci, tap t)
          tensor_copy_4d(smem_addr(taps_s + stage * kStageBytes), &taps_map, n0, chunk * kChunk, t, 0, bar);
          if (act_load) {
            if (!waited) {  // the operand pair: the previous launch's output
              wait_previous();
              waited = true;
            }
            if (own_halo_bar) {
              if (k > 0)  // the one buffer is free once the chunk's last unit is done
                barrier_wait(empty + 8 * ((k - 1) % stages), ((k - 1) / stages) & 1);
              bar = halo_full;
              barrier_expect(bar, loaded * 2 * act_bytes);
            }
            int dy = -reach, dx = -reach;
            if (!p.halo) offset(t, dy, dx);
            const int buf = !p.halo ? stage : act_buffers == 1 ? 0 : (chunk - first_chunk) % 2;
#pragma unroll
            for (int s = 0; s < kSub; ++s)
              if (valid[s])
#pragma unroll
                for (int part = 0; part < 2; ++part)  // hi, then lo
                  tensor_copy_5d(smem_addr(act_s + ((s * act_buffers + buf) * 2 + part) * act_bytes), &act_map, 0,
                                 px0[s] + dx, py0[s] + dy, chunk * kGroups, img[s] + part * p.batch, bar);
          }
        }
      }
    } else {
      const uint32_t lbo_a = act_px * 16, sbo_a = side * 16, lbo_b = kN * 16;
      auto window = [&](int u, int k) {  // the hi tile's 8x8 window of this warpgroup's patch for unit u
        const uint8_t* base = act_s + (mine ? act_buffers * 2 * act_bytes : 0);
        if (!p.halo) return smem_addr(base + (k % stages) * 2 * act_bytes);
        const int chunk = u / n_taps;
        int dy, dx;
        offset(u - chunk * n_taps, dy, dx);
        return smem_addr(base + (act_buffers == 1 ? 0 : (chunk - first_chunk) % 2) * 2 * act_bytes) +
               ((dy + reach) * side + dx + reach) * 16;
      };
      // kSub 1: warpgroup wg takes the slice's units first + wg, first + wg + 2, ..,
      // and splits their tap tiles whole; kSub 2: both take every unit, and
      // each splits half of its tile (groups 4 wg .. 4 wg + 3).
      constexpr int kStride = kSub == 2 ? 1 : kConsumers;
      const int t = tid % 128, n = last - first, k0 = kSub == 2 ? 0 : wg;
      auto split_unit = [&](int k) {
        uint8_t* tile = taps_s + k % stages * kStageBytes;
        if constexpr (kSub == 2) split_tile<kGroups / 2>(tile, t, kGroups / 2 * wg, 3 + wg);
        else split_tile<kGroups>(tile, t, 0, 3 + wg);
      };
      auto stage_sync = [&]() {  // the next stage's split is whole
        if constexpr (kSub == 2) named_sync(1, 256);
        else named_sync(1 + wg, 128);
      };
      float step[kN / 2];
      int halos = 0;  // halo loads waited for on halo_full
      if (k0 < n) {
        barrier_wait(full + 8 * k0, 0);
        split_unit(k0);
      }
      stage_sync();
      for (int k = k0; k < n; k += kStride) {
        const int u = first + k, stage = k % stages;
        if (own_halo_bar && (k == 0 || u % n_taps == 0)) barrier_wait(halo_full, halos++ & 1);
        const uint32_t a = window(u, k), b = smem_addr(taps_s + stage * kStageBytes);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kGroups / 2; ++j) {  // k8 steps: two 16-byte groups each
          const uint64_t a_hi = descriptor(a + 2 * j * lbo_a, lbo_a, sbo_a);
          const uint64_t a_lo = descriptor(a + act_bytes + 2 * j * lbo_a, lbo_a, sbo_a);
          const uint64_t b_hi = descriptor(b + 2 * j * lbo_b, lbo_b, 128);
          const uint64_t b_lo = descriptor(b + kTapBytes + 2 * j * lbo_b, lbo_b, 128);
          wgmma_tf32(step, a_lo, b_hi, j);  // lo*hi, then hi*lo, then hi*hi; the stage from zero
          wgmma_tf32(step, a_hi, b_lo, 1);
          wgmma_tf32(step, a_hi, b_hi, 1);
        }
        wgmma_commit();
        if (k + kStride < n) {  // split the next stage while the tensor cores work
          barrier_wait(full + 8 * ((k + kStride) % stages), ((k + kStride) / stages) & 1);
          split_unit(k + kStride);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) acc[e] += step[e];
        if (t == 0) barrier_arrive(empty + 8 * stage);
        stage_sync();
      }
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) asm volatile("" : "+f"(acc[e])::"memory");
    }
    launch_next();
    wait_previous();  // every write below follows the previous launch
    __syncthreads();  // the ring and the activations' tiles are free

    // acc[4 j + q] is row 16 w + grp (+ 8 for q >= 2), channel 8 j + 2 tig
    // (+ 1 for odd q) of the warpgroup's 64 x 128 tile, w its warp in the
    // warpgroup.
    const int lane = tid % 32, w = tid / 32 % 4, grp = lane / 4, tig = lane % 4;
    float* const part = reinterpret_cast<float*>(smem);
    auto at = [&](int q) { return part + (16 * w + grp + 8 * (q % 4 / 2)) * kPartLd + 8 * (q / 4) + 2 * tig; };
    if constexpr (kSub == 1) {
      // The second warpgroup's sums go through shared memory into the
      // first's, which finishes the tile: each thread of the first reads what
      // its twin of the second wrote, and writes its staged partial tile
      // (below) to the same places.
      if (wg == 1) {
#pragma unroll
        for (int q = 0; q < kN / 2; q += 2) *reinterpret_cast<float2*>(at(q)) = make_float2(acc[q], acc[q + 1]);
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int q = 0; q < kN / 2; q += 2) {
          const float2 v = *reinterpret_cast<const float2*>(at(q));
          acc[q] += v.x;
          acc[q + 1] += v.y;
        }
      }
    }
    if (p.splits == 1) {
      if (wg == kConsumers || (kSub == 1 && wg != 0) || !my_valid) return;
#pragma unroll
      for (int q = 0; q < kN / 2; ++q) {
        const int m = 16 * w + grp + 8 * (q % 4 / 2), c = n0 + 8 * (q / 4) + 2 * tig + q % 2;
        const int y = my_py0 + m / 8, xx = my_px0 + m % 8;
        if (c < channels && y < p.height && xx < p.width) finish<kPass>(p, x, aff, acc[q], my_img, y * p.width + xx, c);
      }
      return;
    }
    if constexpr (kSub == 1) {
      // Slices: the partial tile in shared memory, then the cluster's sum
      if (wg == 0) {
#pragma unroll
        for (int q = 0; q < kN / 2; q += 2) *reinterpret_cast<float2*>(at(q)) = make_float2(acc[q], acc[q + 1]);
      }
      cluster_sync();
      const int cs = p.cluster, rank = static_cast<int>(cluster_rank());
      const int m0 = rank * kTileP / cs, m1 = (rank + 1) * kTileP / cs;  // this block's rows of the sum
      const size_t groups = p.splits / cs, grp_idx = split / cs;
      const int hw = p.height * p.width;
      for (int i = tid; i < (m1 - m0) * kN / 4; i += blockDim.x) {
        const int m = m0 + i / (kN / 4), n = 4 * (i % (kN / 4));
        const uint32_t addr = smem_addr(part + m * kPartLd + n);
        float4 v = load_peer(addr, 0);
        for (int r = 1; r < cs; ++r) {
          const float4 q = load_peer(addr, r);
          v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
        }
        const int y = py0[0] + m / 8, xx = px0[0] + m % 8;
        if (y >= p.height || xx >= p.width) continue;
        const int pix = y * p.width + xx;
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = n0 + n + k;
          if (c >= channels) continue;
          if (groups == 1) {
            finish<kPass>(p, x, aff, e[k], img[0], pix, c);
          } else {
            const size_t image = img[0] * groups + grp_idx;
            p.partial[kPass == 1 ? (image * hw + pix) * channels + c : (image * channels + c) * hw + pix] = e[k];
          }
        }
      }
      cluster_sync();  // no block leaves while a peer reads its tile
    }
  }
}

// The clusters' sums: the epilogue of the sum over the groups, in order, of
// partial[img, group, i] for the elements i of image blockIdx.y, four a
// thread, in the output's layout (pass 1 pixel-major, pass 2 NCHW).
template <int kPass>
__global__ void __launch_bounds__(kThreads)
add_slices_kernel(const float* __restrict__ partial, const float* __restrict__ x, const float* __restrict__ aff,
                  float* __restrict__ out, const Fwd p) {
  launch_next();
  wait_previous();
  const int hw = p.height * p.width, per_image = p.channels * hw, groups = p.splits / p.cluster;
  const int i = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (i >= per_image) return;
  const float* src = partial + static_cast<size_t>(blockIdx.y) * groups * per_image + i;
  float4 v = *reinterpret_cast<const float4*>(src);
  for (int k = 1; k < groups; ++k) {
    const float4 q = *reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * per_image);
    v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = i + k;
    if (kPass == 1) finish<kPass>(p, x, aff, e[k], blockIdx.y, j / p.channels, j % p.channels);
    else finish<kPass>(p, x, aff, e[k], blockIdx.y, j % hw, j / hw);
  }
}

// Dynamic shared memory of one MDCL block: the tap ring, the activations'
// tiles of its `sub` patches, the two barriers a stage (as `fwd_smem_bytes`
// in mdblock.py).
int smem_bytes(bool halo, int sub, int stages, int radius) {
  const int side = halo ? 8 + 2 * radius : 8, buffers = !halo ? stages : sub == 2 ? 1 : 2;
  return stages * kStageBytes + sub * buffers * 2 * side * side * 16 * kGroups + 2 * kMaxStages * 8;
}

// The tensor maps of one MDCL: its taps (T, C in, C out) as they lie, boxes
// of 128 outputs by 32 inputs; its operand pair pixel-major, (4 channels,
// width, height, C / 4 groups, hi images then lo), boxes of side^2 pixels by
// a chunk.
cudaError_t mdcl_maps(const Fwd& p, const float* pair, const float* taps, CUtensorMap* taps_map,
                      CUtensorMap* act_map) {
  const cuuint64_t c = p.channels, f = sizeof(float);
  const cuuint64_t taps_dims[4] = {c, c, 9ull * p.branches.n, 1};
  const cuuint64_t taps_strides[3] = {f * c, f * c * c, f * c * c * taps_dims[2]};
  const cuuint32_t taps_box[4] = {kN, kChunk, 1, 1};
  cudaError_t err = tensor_map(taps_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, taps, 4, taps_dims, taps_strides, taps_box);
  const cuuint64_t w = p.width, h = p.height;
  const cuuint64_t act_dims[5] = {4, w, h, c / 4, 2ull * p.batch};
  const cuuint64_t act_strides[4] = {f * c, f * c * w, 16, f * c * w * h};
  const cuuint32_t side = p.halo ? 8 + 2 * p.radius : 8;
  const cuuint32_t act_box[5] = {4, side, side, kGroups, 1};
  if (err == cudaSuccess)
    err = tensor_map(act_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pair, 5, act_dims, act_strides, act_box);
  return err;
}

// One MDCL (pass 1 or 2) of kSub patches a block and, where a tile's slices
// outnumber a cluster, its clusters' sum.
template <int kPass, int kSub>
cudaError_t launch_mdcl(Fwd p, const float* x, const float* aff, const float* pair, const float* taps,
                        float* out, cudaStream_t s) {
  p.out = out;
  CUtensorMap taps_map{}, act_map{};
  cudaError_t err = mdcl_maps(p, pair, taps, &taps_map, &act_map);
  const int bytes = smem_bytes(p.halo, kSub, p.stages, p.radius);
  if (err == cudaSuccess) err = allow_dynamic_smem<mdcl_kernel<kPass, kSub>>(bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (p.patches + kSub - 1) / kSub * ((p.channels + kN - 1) / kN);
  err = launch(mdcl_kernel<kPass, kSub>, dim3(tiles, p.splits), kMdclThreads, bytes, p.cluster, true, s, x, aff,
               taps, p, taps_map, act_map);
  if (err != cudaSuccess || p.splits == p.cluster) return err;
  const int quads = p.channels * p.height * p.width / 4;
  return launch(add_slices_kernel<kPass>, dim3((quads + kThreads - 1) / kThreads, p.batch), kThreads, 0, 1, true, s,
                static_cast<const float*>(p.partial), x, aff, out, p);
}

}  // namespace

// x, out: (batch, channels, height, width) float32 NCHW; taps1, taps2:
// (9 * n_branches, channels, channels) as (tap, in, out); aff: (6, channels),
// rows s0, t0, s1, t1, s2, t2; act, h1_pair: scratch of twice x's size (the
// operand pairs of MDCL1's and MDCL2's inputs, pixel-major, the lo images
// after the hi); h1: x's size, h1 NCHW for the backward, or null; partial:
// scratch (batch, splits / cluster, channels * height * width), unused when
// splits == cluster; dilations: host array of n_branches <= 8 ints; the plan,
// as the wrapper's `fwd_plan` gives it: halo (1: a halo tile a chunk; 0: a
// window a unit), sub_tiles (1, or 2 patches a block with halo tiles and
// one slice), stages (3..7 tap stages), splits (slices of the units) and
// cluster (1..8 blocks dividing splits). channels a multiple of 16,
// height * width of 64. All device tensors contiguous and 16-byte aligned.
// 3 to 5 launches on `stream`; returns the first CUDA error code (0 = all
// launched).
extern "C" int npe_mdblock(const void* x, const void* taps1, const void* taps2, const void* aff, void* act,
                           void* h1_pair, void* h1, void* partial, void* out, int batch, int channels, int height,
                           int width, int n_branches, const int* dilations, int halo, int sub_tiles, int stages,
                           int splits, int cluster, void* stream) {
  const int hw = height * width;
  if (n_branches < 1 || n_branches > kMaxBranches || channels % 16 || hw % kTileP || batch < 1 || stages < 3 ||
      stages >= kMaxStages || cluster < 1 || cluster > 8 || splits < 1 || splits % cluster ||
      (sub_tiles != 1 && !(sub_tiles == 2 && halo && splits == 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Fwd p{};
  p.branches.n = n_branches;
  for (int b = 0; b < kMaxBranches; ++b) {
    p.branches.dilation[b] = b < n_branches ? dilations[b] : 0;
    if (b < n_branches && dilations[b] > p.radius) p.radius = dilations[b];
  }
  p.halo = halo != 0;
  if (smem_bytes(p.halo, sub_tiles, stages, p.radius) > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  p.batch = batch;
  p.channels = channels;
  p.height = height;
  p.width = width;
  p.patches_x = (width + 7) / 8;
  p.patches = batch * p.patches_x * ((height + 7) / 8);
  p.units = (channels + kChunk - 1) / kChunk * 9 * n_branches;
  if (splits > p.units) return static_cast<int>(cudaErrorInvalidValue);
  p.splits = splits;
  p.cluster = cluster;
  p.stages = stages;
  p.partial = static_cast<float*>(partial);
  p.h1 = static_cast<float*>(h1);
  p.out = static_cast<float*>(act);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(aff);
  CUtensorMap none{};
  mdcl_kernel<0, 1><<<dim3(hw / kTileP, (channels + 63) / 64, batch), kThreads, 0, s>>>(xf, af, nullptr, p, none,
                                                                                        none);
  cudaError_t err = cudaGetLastError();
  const auto mdcl1 = sub_tiles == 2 ? launch_mdcl<1, 2> : launch_mdcl<1, 1>;
  const auto mdcl2 = sub_tiles == 2 ? launch_mdcl<2, 2> : launch_mdcl<2, 1>;
  if (err == cudaSuccess)
    err = mdcl1(p, xf, af, static_cast<const float*>(act), static_cast<const float*>(taps1),
                static_cast<float*>(h1_pair), s);
  p.h1 = nullptr;
  if (err == cudaSuccess)
    err = mdcl2(p, xf, af, static_cast<const float*>(h1_pair), static_cast<const float*>(taps2),
                static_cast<float*>(out), s);
  return static_cast<int>(err);
}
