// mdblock_bwd: x's gradient of the inference MDBLOCK (mdblock.cu,
// mdblock_bf16.cu), hand-written for Hopper (sm_90a), float32 and bf16.
//
// Replaces npe_tpu's `_fused_bwd` (npe_tpu/ops/pallas/mdcl_kernels.py:155),
// the custom VJP of the Pallas kernel `mdblock_fused`: for a cotangent g of
// y and the forward's h1 and y,
//
//   g_r  = s2 * lrelu'(a2) * g                   lrelu'(a2) from the sign of y
//   g_m1 = s1 * lrelu'(a1) * MDCL2^T(g_r)        lrelu'(a1) from the sign of h1
//   dx   = g_r + s0 * lrelu'(s0 * x + t0) * MDCL1^T(g_m1)
//   MDCL^T(g)[ci, p] = sum_t sum_co g[co, p + offset_t] * taps[m(t), ci, co]
//
// with lrelu'(a) = 1 for a > 0, else 0.2 (torch's VJP: 0.2 at 0), and m(t)
// = 9 floor(t / 9) + 8 - t mod 9 the tap of the opposite offset (a branch's
// nine offsets are symmetric). The taps' and affines' gradients stay the
// plain VJP: no path asks for them.
//
// Bound. Each MDCL^T is an implicit GEMM of M = pixels by N = C (ci) out of
// K = T * C (co), the forward's multiply-adds: 2 * H*W * T * C^2 a block.
// At one image (the editor's stroke, `imgrad`) the tap tensors' bytes bound
// it, 38 MB float32 / 19 MB bf16 at 8x8x512 (11.5 / 5.7 us at 3.35 TB/s), and
// at 16x16x256 and 32x32x128 the operations of three TF32 products a
// multiply-add (11 us) or of two bf16 ones; in practice at one image the
// fixed costs of each launch and each slice's pipeline fill. From batch 8 on
// the operations bound it: 0.47 ms an MDCL^T at 8x8x512 batch 128 in 3xTF32,
// 0.16 ms in bf16 pairs (PERF.md has the measured times against the bound).
//
// Design, in the order the work goes:
// 1. A prologue launch (bwd_prologue_kernel, bwd_prologue_bf16_kernel) reads
//    g and y (NCHW) and writes g_r pixel-major (NHWC) as an operand pair,
//    hi = rnd(v) and lo = rnd(v - hi), the lo images after the hi: TF32
//    (cvt.rna) in float32, bf16 in bf16. hi + lo holds v to about 21 bits in
//    float32 and 16 in bf16; the plain VJP never rounds g_r, and one bf16
//    alone sat past the 4-step rule (PERF.md). MDCL2^T's epilogue writes g_m1
//    as the same pair.
// 2. Each MDCL^T is one kernel of 128-thread consumer warpgroups and one
//    producer warp. A unit is (chunk, tap): a chunk is 32 input channels co
//    (float32) or 64 (bf16), 128 bytes a pixel either way. The producer's one
//    thread arms a stage's mbarrier and asks the tensor memory accelerator
//    for the tap tile, a 4-D box of rows ci (the tile's output channels)
//    by the chunk's columns co of taps[m(t)] as they lie, which lands as
//    wgmma's K-major B (core matrices of 8 rows x 16 bytes); and, when u
//    starts a chunk or the slice, for each patch's halo tiles: one 5-D box of
//    (8 + 2R)^2 pixels by the chunk's channels of the pair's hi image and one
//    of its lo image (R the largest dilation; zeros outside the image and
//    past C). Every tap of every branch reads its shifted 8x8 window of those
//    tiles by the descriptor alone (start address moved by the tap's offset,
//    SBO one halo row, LBO one channel plane): no thread stages an operand
//    through its registers, and the activations are read once a chunk, not
//    once a tap.
// 3. The stages are a ring released by mbarriers: a full barrier a stage
//    (the copies' bytes) and an empty one (one arrival per consumer
//    warpgroup once its products have read the stage). The producer runs as
//    far ahead as the ring allows; no block barrier is taken per step. The
//    halo tiles alternate between two buffers by chunk where they fit
//    (`bwd_plan`), else the producer waits for the chunk's last unit.
// 4. float32: 3xTF32 wgmma m64n128k8 (both operands K-major, as TF32
//    wgmma wants them). The tap tile arrives as float32 and is split once in
//    shared memory into TF32 hi (in place) and lo, by the consumers, while
//    the previous stage's products run on the tensor cores. Each stage is
//    lo*hi + hi*lo + hi*hi summed from zero, then added to float32 running
//    sums (the tensor cores truncate a sum carried over thousands of
//    products: mdblock.cu's header). One consumer warpgroup a block.
//    bf16: wgmma m64n128k16, the tap tile once a unit and two products on
//    the same B descriptor, one with the hi halo tile and one with the lo,
//    into the same float32 sums (the forward's accuracy argument: some 1e-4
//    relative drift against a 1.2e-2 rule), two wgmma groups in flight; once
//    the batch gives every SM two output tiles, two warpgroups over the same
//    tap stages, and where C >= 256 tiles of 256 channels (m64n256k16).
// 5. Batch 1: the output has 4 to 16 tiles for 132 SMs, so the inner
//    dimension is cut into slices over blockIdx.y, and the slices of a tile
//    run as a thread-block cluster of up to 8 blocks. Each block stages its
//    partial tile in its shared memory; after a cluster barrier block r of n
//    adds rows 64r/n .. 64(r+1)/n of every peer's tile through distributed
//    shared memory, peers in rank order (fixed order, no atomics: two calls are
//    bit-equal), and applies the epilogue. Only where a tile has more slices
//    than a cluster holds does it write the cluster's sum to float32 partials
//    that a second launch adds in cluster order.
// 6. Launches after the prologue use programmatic dependent launch: a
//    block's set-up and its first tap copies overlap the tail of the launch
//    before; the copies of the previous launch's output, and every write,
//    wait for it (griddepcontrol.wait).
// A call is 3 launches (prologue, MDCL2^T, MDCL1^T), or 5 where the plan's
// slices outnumber a cluster (8x8x512 and 16x16x256 at one image).
//
// What bounds it now (PERF.md has the times; one H100 at 700 W;
// scripts/kernel_sweep.py mdblock_bwd plan sweeps the plan). At one image,
// fixed costs: each launch, each slice's first copies, the cluster's sum,
// and a second sum launch where there is one (3.7 us a call in bf16 at
// 32x32x128: six slices in one cluster 0.0400 ms, in two 0.0437); the plan
// (`bwd_plan`) trades slices against those. The card holds 15 clusters of 8
// blocks at one block an SM (30 of 4, 66 of 2), not 132 / 8: a plan of 16
// clusters of 8 runs in two waves (float32 0.0760 / 0.0960 / 0.0978 ms a
// call at full IAN's three shapes, against 0.0518 / 0.0635 / 0.0632 on the
// plan that fits). From batch 8 on, float32 is bound by shared memory: a
// unit's three TF32 products read 72 KB of operands and the tap split moves
// 48 KB, some 940 cycles of bandwidth against 740 of tensor work; bf16 at
// batch 128 runs at 13-21 % of the tensor cores' peak, its tap tiles' traffic
// from L2 halved by 256-channel tiles (0.748 against 0.867 ms at 8x8x512).
// Timed and rejected: slices summed by the second launch alone, without a
// cluster (float32 8x8x512 at one image: 0.0672 ms against 0.0518); one
// patch a block at batch 128 in bf16 (1.18 ms against 0.75 at 8x8x512: the
// tap tiles are read twice as often); three float32 stages instead of four
// (2.83 against 2.68 ms at batch 128).
//
// Rounding points: float32 rounds nowhere but the operand split (the same
// hi and lo as the 3xTF32 products of the forward). bf16 rounds where the
// plain version's VJP does (each MDCL^T's sum to bf16, dx once at the end;
// g_r in dx's sum stays float32, formed again from g and y) and at the
// pairs' split: mdblock.py's `mdblock_backward_reference`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "dynamic_smem.cuh"
#include "tma.cuh"

namespace {

using namespace npe;
using bf16 = __nv_bfloat16;

constexpr int kTileP = 64;            // pixels of a patch (8x8): a warpgroup's M
constexpr int kGroups = 8;            // 16-byte channel groups of a chunk
constexpr int kMaxBranches = 8;
constexpr int kMaxStages = 8;
constexpr int kThreads = 256;         // the prologue's and add_slices' blocks

struct Branches {
  int n;
  int dilation[kMaxBranches];
};

// One MDCL^T launch.
template <typename T>
struct Bwd {
  Branches branches;
  int batch, channels, height, width;
  int patches_x, patches;  // 8x8 patches a row of an image; in the batch
  int radius;
  int units, splits, cluster, stages, halo_buffers;
  int mode;                // 1: MDCL2^T, out = g_m1's pair (pixel-major); 2: MDCL1^T, out = dx (NCHW)
  T* out;
  float* partial;          // splits > cluster: (batch, splits / cluster, ...) in the output's layout
  const float* aff;        // (6, C): s0, t0, s1, t1, s2, t2
  const T* mask;           // mode 1: the forward's h1 (float32 NCHW, bf16 pixel-major); mode 2: x (NCHW)
  const T* grad;           // mode 2: g and y (NCHW), which give g_r again
  const T* y;
};

// The forms: a 16-byte group holds 4 float32 or 8 bf16 channels.
template <typename T>
constexpr int kLanes = 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr bool kF32 = std::is_same_v<T, float>;
// A tile is kN output channels (ci): wgmma's N, 128, or 256 in bf16 with two
// patches a block.
template <int kN>
constexpr int kTapBytes = kGroups * kN * 16;  // a tap tile: 16 or 32 KB
template <typename T, int kN>
constexpr int kStageBytes = kTapBytes<kN> * (kF32<T> ? 2 : 1);  // float32: the tile's hi, then its lo
template <int kN>
constexpr int kPartLd = kN + 4;  // floats a row of a staged partial tile

__device__ __forceinline__ float slope(float a, float v) { return a > 0.0f ? v : v * 0.2f; }

// An operand pair: hi = rnd(v), lo = rnd(v - hi) (TF32 or bf16).
template <typename T>
__device__ __forceinline__ void store_pair(T* hi, size_t lo_offset, float v) {
  if constexpr (kF32<T>) {
    const float h = tf32(v);
    hi[0] = h;
    hi[lo_offset] = tf32(v - h);
  } else {
    const bf16 h = __float2bfloat16_rn(v);
    hi[0] = h;
    hi[lo_offset] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// The epilogue of a finished sum v of channel c at pixel pix of image img:
// g_m1's pair (mode 1) or dx (mode 2). bf16 rounds v to bf16 first.
template <typename T>
__device__ __forceinline__ void finish(const Bwd<T>& p, float v, size_t img, int pix, int c) {
  const int channels = p.channels, hw = p.height * p.width;
  const size_t nchw = (img * channels + c) * hw + pix, nhwc = (img * hw + pix) * channels + c;
  if constexpr (!kF32<T>) v = round_to<bf16>(v);
  if (p.mode == 1) {
    const float h1 = to_f32(p.mask[kF32<T> ? nchw : nhwc]);
    store_pair(p.out + nhwc, static_cast<size_t>(p.batch) * hw * channels,
               slope(h1, v) * __ldg(p.aff + 2 * channels + c));
    return;
  }
  const float s0 = __ldg(p.aff + c);
  const float a0 = __fadd_rn(__fmul_rn(to_f32(p.mask[nchw]), s0), __ldg(p.aff + channels + c));
  const float gr = slope(to_f32(p.y[nchw]), to_f32(p.grad[nchw])) * __ldg(p.aff + 4 * channels + c);
  p.out[nchw] = from_f32<T>(gr + slope(a0, v) * s0);
}

// The TF32 split of a float32 tap tile in place: hi over the tile, lo
// kTapBytes on; the consumer warpgroup's 128 threads a 16-byte group each.
__device__ __forceinline__ void split_tile(uint8_t* tile, int t) {
#pragma unroll
  for (int r = 0; r < kTapBytes<128> / 16 / 128; ++r) {
    float4* at = reinterpret_cast<float4*>(tile) + t + 128 * r;
    const float4 v = *at;
    const float4 hi = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
    *at = hi;
    *reinterpret_cast<float4*>(tile + kTapBytes<128> + 16 * (t + 128 * r)) =
        make_float4(tf32(v.x - hi.x), tf32(v.y - hi.y), tf32(v.z - hi.z), tf32(v.w - hi.w));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's reads
}

// One MDCL^T over the slice blockIdx.y of its units: kSub consumer
// warpgroups, each with its own 8x8 patch, over one tile of kN output
// channels, and a producer warp (the header's steps 2-5).
template <typename T, int kSub, int kN>
__global__ void __launch_bounds__(128 * kSub + 32, 1)
mdcl_bwd_kernel(const Bwd<T> p, const __grid_constant__ CUtensorMap taps_map,
                const __grid_constant__ CUtensorMap act_map) {
  static_assert((kSub == 1 && kN == 128) || !kF32<T>, "the float32 tap split is one warpgroup's, 128 channels");
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int channels = p.channels, hw = p.height * p.width, stages = p.stages;
  const int tiles_c = (channels + kN - 1) / kN;
  const int n0 = blockIdx.x % tiles_c * kN, group = blockIdx.x / tiles_c, split = blockIdx.y;
  const int n_taps = 9 * p.branches.n;
  const int first = static_cast<int>(static_cast<long long>(split) * p.units / p.splits);
  const int last = static_cast<int>(static_cast<long long>(split + 1) * p.units / p.splits);
  const int first_chunk = first / n_taps;
  const int radius = p.radius, halo_w = 8 + 2 * radius, halo_px = halo_w * halo_w;
  const int halo_bytes = halo_px * 16 * kGroups;
  uint8_t* const taps_s = smem;
  uint8_t* const halo_s = smem + stages * kStageBytes<T, kN>;  // [sub][buffer][hi, lo][halo_bytes]
  const uint32_t full = smem_addr(halo_s + kSub * p.halo_buffers * 2 * halo_bytes), empty = full + 8 * kMaxStages;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      barrier_init(full + 8 * i);
      barrier_init<kSub>(empty + 8 * i);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each patch of the block: its image and its top-left corner.
  int img[kSub], py0[kSub], px0[kSub];
  bool valid[kSub];
  const int per_image = p.patches / p.batch;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int idx = group * kSub + s;
    valid[s] = idx < p.patches;
    img[s] = valid[s] ? idx / per_image : 0;
    const int t = idx % per_image;
    py0[s] = 8 * (t / p.patches_x);
    px0[s] = 8 * (t % p.patches_x);
  }

  float acc[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = 0.0f;

  if (wg == kSub) {
    // The producer warp: its first thread issues every copy.
    if (tid == 128 * kSub) {
      bool waited = false;
      for (int u = first; u < last; ++u) {
        const int k = u - first, stage = k % stages;
        if (k >= stages) barrier_wait(empty + 8 * stage, (k / stages - 1) & 1);  // unit u - stages is done
        const int chunk = u / n_taps, t = u - chunk * n_taps;
        const bool halo_load = t == 0 || u == first;
        if (halo_load && p.halo_buffers == 1 && k > 0)  // one buffer: the chunk's last unit is done
          barrier_wait(empty + 8 * ((k - 1) % stages), ((k - 1) / stages) & 1);
        int loaded = 0;
#pragma unroll
        for (int s = 0; s < kSub; ++s) loaded += halo_load && valid[s];
        const uint32_t bar = full + 8 * stage;
        barrier_expect(bar, kTapBytes<kN> + loaded * 2 * halo_bytes);
        // (16 bytes of columns co, kN rows ci, the mirrored tap, 8 groups of columns)
        tensor_copy_4d(smem_addr(taps_s + stage * kStageBytes<T, kN>), &taps_map, 0, n0, 9 * (t / 9) + 8 - t % 9,
                       chunk * kGroups, bar);
        if (halo_load) {
          if (!waited) {  // g_r or g_m1: the previous launch's output
            wait_previous();
            waited = true;
          }
          const int buf = (chunk - first_chunk) % p.halo_buffers;
#pragma unroll
          for (int s = 0; s < kSub; ++s)
            if (valid[s])
#pragma unroll
              for (int part = 0; part < 2; ++part)  // hi, then lo
                tensor_copy_5d(smem_addr(halo_s + ((s * p.halo_buffers + buf) * 2 + part) * halo_bytes), &act_map, 0,
                               px0[s] - radius, py0[s] - radius, chunk * kGroups, img[s] + part * p.batch, bar);
        }
      }
    }
  } else {
    const uint32_t lbo_a = halo_px * 16, sbo_a = halo_w * 16, lbo_b = kN * 16;
    auto window = [&](int u) {  // the hi halo tile's shifted window for unit u
      const int chunk = u / n_taps, t = u - chunk * n_taps;
      const int dil = p.branches.dilation[t / 9];
      const int dy = (t % 9 / 3 - 1) * dil, dx = (t % 3 - 1) * dil;
      const int buf = (chunk - first_chunk) % p.halo_buffers;
      return smem_addr(halo_s + (wg * p.halo_buffers + buf) * 2 * halo_bytes) +
             ((dy + radius) * halo_w + dx + radius) * 16;
    };
    if constexpr (kF32<T>) {
      float step[kN / 2];
      const int t = tid % 128;
      barrier_wait(full, 0);
      split_tile(taps_s, t);
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      for (int u = first; u < last; ++u) {
        const int k = u - first, stage = k % stages;
        const uint32_t a = window(u), b = smem_addr(taps_s + stage * kStageBytes<T, kN>);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kGroups / 2; ++j) {  // k8 steps: two 16-byte groups each
          const uint64_t a_hi = descriptor(a + 2 * j * lbo_a, lbo_a, sbo_a);
          const uint64_t a_lo = descriptor(a + halo_bytes + 2 * j * lbo_a, lbo_a, sbo_a);
          const uint64_t b_hi = descriptor(b + 2 * j * lbo_b, lbo_b, 128);
          const uint64_t b_lo = descriptor(b + kTapBytes<kN> + 2 * j * lbo_b, lbo_b, 128);
          wgmma_tf32(step, a_lo, b_hi, j);  // lo*hi, then hi*lo, then hi*hi; the stage from zero
          wgmma_tf32(step, a_hi, b_lo, 1);
          wgmma_tf32(step, a_hi, b_hi, 1);
        }
        wgmma_commit();
        if (u + 1 < last) {  // split the next stage while the tensor cores work
          const int next = (k + 1) % stages;
          barrier_wait(full + 8 * next, ((k + 1) / stages) & 1);
          split_tile(taps_s + next * kStageBytes<T, kN>, t);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) acc[e] += step[e];
        if (t == 0) barrier_arrive(empty + 8 * stage);
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the next stage's split is whole
      }
    } else {
      int released = 0;  // units of the slice whose stages went back to the producer
      auto release_to = [&](int end) {
        for (; released < end; ++released)
          if (tid % 128 == 0) barrier_arrive(empty + 8 * (released % stages));
      };
      for (int u = first; u < last; ++u) {
        const int k = u - first, stage = k % stages;
        barrier_wait(full + 8 * stage, (k / stages) & 1);
        const uint32_t a = window(u), b = smem_addr(taps_s + stage * kStageBytes<T, kN>);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kGroups / 2; ++j) {  // k16 steps: one tap tile, the hi and lo windows
          const uint64_t desc_b = descriptor(b + 2 * j * lbo_b, lbo_b, 128);
          wgmma_bf16<kN, 0>(acc, descriptor(a + 2 * j * lbo_a, lbo_a, sbo_a), desc_b);
          wgmma_bf16<kN, 0>(acc, descriptor(a + halo_bytes + 2 * j * lbo_a, lbo_a, sbo_a), desc_b);
        }
        wgmma_commit();
        if (p.halo_buffers == 1 && (u + 1) % n_taps == 0) {
          wgmma_wait<0>();  // the chunk's last unit: its halo buffer goes back with it
          release_to(k + 1);
        } else {
          wgmma_wait<2>();  // two groups stay in flight: unit u - 2's products are done
          release_to(k - 1);
        }
      }
      wgmma_wait<0>();
    }
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) asm volatile("" : "+f"(acc[e])::"memory");
  }
  launch_next();
  wait_previous();  // every write below follows the previous launch
  __syncthreads();  // the ring and the halo tiles are free

  // acc[4 j + q] is row 16 w + grp (+ 8 for q >= 2), channel 8 j + 2 tig
  // (+ 1 for odd q) of the warpgroup's 64 x kN tile, w its warp.
  const int lane = tid % 32, w = (tid % 128) / 32, grp = lane / 4, tig = lane % 4;
  if (p.splits == 1) {
    if (wg == kSub || !valid[wg]) return;
#pragma unroll
    for (int q = 0; q < kN / 2; ++q) {
      const int m = 16 * w + grp + 8 * (q % 4 / 2), c = n0 + 8 * (q / 4) + 2 * tig + q % 2;
      const int y = py0[wg] + m / 8, x = px0[wg] + m % 8;
      if (c < channels && y < p.height && x < p.width) finish(p, acc[q], img[wg], y * p.width + x, c);
    }
    return;
  }
  // Slices: the partial tile in shared memory, then the cluster's sum
  float* const part = reinterpret_cast<float*>(smem);
  if (wg < kSub) {
#pragma unroll
    for (int q = 0; q < kN / 2; q += 2)
      *reinterpret_cast<float2*>(part + (16 * w + grp + 8 * (q % 4 / 2)) * kPartLd<kN> + 8 * (q / 4) + 2 * tig) =
          make_float2(acc[q], acc[q + 1]);
  }
  cluster_sync();
  const int cs = p.cluster, rank = static_cast<int>(cluster_rank());
  const int m0 = rank * kTileP / cs, m1 = (rank + 1) * kTileP / cs;  // this block's rows of the sum
  const size_t groups = p.splits / cs, grp_idx = split / cs;
  for (int i = tid; i < (m1 - m0) * kN / 4; i += blockDim.x) {
    const int m = m0 + i / (kN / 4), n = 4 * (i % (kN / 4));
    const uint32_t at = smem_addr(part + m * kPartLd<kN> + n);
    float4 v = load_peer(at, 0);
    for (int r = 1; r < cs; ++r) {
      const float4 q = load_peer(at, r);
      v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
    }
    const int y = py0[0] + m / 8, x = px0[0] + m % 8;
    if (y >= p.height || x >= p.width) continue;
    const int pix = y * p.width + x;
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = n0 + n + k;
      if (c >= channels) continue;
      if (groups == 1) {
        finish(p, e[k], img[0], pix, c);
      } else {
        const size_t image = img[0] * groups + grp_idx;
        p.partial[p.mode == 1 ? (image * hw + pix) * channels + c : (image * channels + c) * hw + pix] = e[k];
      }
    }
  }
  cluster_sync();  // no block leaves while a peer reads its tile
}

// The clusters' sums: the epilogue of the sum over the groups, in order, of
// partial[img, group, i] for the elements i of image blockIdx.y, four a
// thread, in the output's layout (g_m1's pair pixel-major, dx NCHW).
template <typename T>
__global__ void __launch_bounds__(kThreads) add_slices_bwd_kernel(const Bwd<T> p) {
  launch_next();
  wait_previous();
  const int hw = p.height * p.width, per_image = p.channels * hw, groups = p.splits / p.cluster;
  const int i = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (i >= per_image) return;
  const float* src = p.partial + static_cast<size_t>(blockIdx.y) * groups * per_image + i;
  float4 v = *reinterpret_cast<const float4*>(src);
  for (int k = 1; k < groups; ++k) {
    const float4 q = *reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * per_image);
    v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = i + k;
    if (p.mode == 1) finish(p, e[k], blockIdx.y, j / p.channels, j % p.channels);
    else finish(p, e[k], blockIdx.y, j % hw, j / hw);
  }
}

// g_r = s2 * lrelu'(a2) * g from g and y (NCHW), written pixel-major as its
// operand pair, the lo images after the hi; a block turns a 64-channel x
// 64-pixel tile of one image through shared memory.
template <typename T>
__device__ __forceinline__ void bwd_prologue(const T* __restrict__ g, const T* __restrict__ y,
                                             const float* __restrict__ s2, T* __restrict__ gr, int channels,
                                             int hw) {
  launch_next();
  __shared__ float tile[64][kTileP + 1];  // [channel][pixel]
  const size_t lo = static_cast<size_t>(gridDim.z) * hw * channels;
  const int p0 = blockIdx.x * kTileP, c0 = blockIdx.y * 64;
  const size_t n = blockIdx.z;
  for (int i = threadIdx.x; i < 64 * kTileP / 4; i += kThreads) {
    const int c = i / (kTileP / 4), q = i % (kTileP / 4);
    if (c0 + c >= channels) continue;
    const size_t at = (n * channels + c0 + c) * hw + p0 + 4 * q;
    const float4 gv = load4(g + at), yv = load4(y + at);
    const float s = __ldg(s2 + c0 + c);
    tile[c][4 * q] = slope(yv.x, gv.x) * s;
    tile[c][4 * q + 1] = slope(yv.y, gv.y) * s;
    tile[c][4 * q + 2] = slope(yv.z, gv.z) * s;
    tile[c][4 * q + 3] = slope(yv.w, gv.w) * s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * kTileP; i += kThreads) {
    const int px = i / 64, c = i % 64;
    if (c0 + c < channels) store_pair(gr + (n * hw + p0 + px) * channels + c0 + c, lo, tile[c][px]);
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_prologue_kernel(const float* __restrict__ g, const float* __restrict__ y, const float* __restrict__ s2,
                    float* __restrict__ gr, int channels, int hw) {
  bwd_prologue(g, y, s2, gr, channels, hw);
}

__global__ void __launch_bounds__(kThreads)
bwd_prologue_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y, const float* __restrict__ s2,
                         bf16* __restrict__ gr, int channels, int hw) {
  bwd_prologue(g, y, s2, gr, channels, hw);
}

// Dynamic shared memory of one MDCL^T block: the tap ring, the halo tiles,
// the two barriers a stage (as `bwd_smem_bytes` in mdblock.py).
template <typename T>
int smem_bytes(int sub, int tile_n, int stages, int halo_buffers, int radius) {
  const int halo_w = 8 + 2 * radius;
  return stages * (tile_n == 256 ? kStageBytes<T, 256> : kStageBytes<T, 128>) +
         sub * halo_buffers * 2 * halo_w * halo_w * 16 * kGroups + 2 * kMaxStages * 8;
}

template <typename T, int kSub, int kN>
cudaError_t launch_mdcl(const Bwd<T>& p, const T* in, const T* taps, cudaStream_t s) {
  const int bytes = smem_bytes<T>(kSub, kN, p.stages, p.halo_buffers, p.radius);
  const cuuint64_t c = p.channels, e = kLanes<T>, size = sizeof(T);
  const CUtensorMapDataType type = kF32<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap taps_map{}, act_map{};
  // taps (T, C in, C out) read as K-major B: (16 bytes of outputs, C inputs, T taps, C / e output groups)
  const cuuint64_t taps_dims[4] = {e, c, 9ull * p.branches.n, c / e};
  const cuuint64_t taps_strides[3] = {size * c, size * c * c, 16};
  const cuuint32_t taps_box[4] = {static_cast<cuuint32_t>(e), kN, 1, kGroups};
  cudaError_t err = tensor_map(&taps_map, type, taps, 4, taps_dims, taps_strides, taps_box);
  // the pixel-major pair: (16 bytes of channels, width, height, C / e groups, hi images then lo)
  const cuuint64_t w = p.width, h = p.height;
  const cuuint64_t act_dims[5] = {e, w, h, c / e, 2ull * p.batch};
  const cuuint64_t act_strides[4] = {size * c, size * c * w, 16, size * c * w * h};
  const cuuint32_t side = 8 + 2 * p.radius;
  const cuuint32_t act_box[5] = {static_cast<cuuint32_t>(e), side, side, kGroups, 1};
  if (err == cudaSuccess) err = tensor_map(&act_map, type, in, 5, act_dims, act_strides, act_box);
  if (err == cudaSuccess) err = allow_dynamic_smem<mdcl_bwd_kernel<T, kSub, kN>>(bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (p.patches + kSub - 1) / kSub * ((p.channels + kN - 1) / kN);
  err = launch(mdcl_bwd_kernel<T, kSub, kN>, dim3(tiles, p.splits), 128 * kSub + 32, bytes, p.cluster, true, s, p,
               taps_map, act_map);
  if (err != cudaSuccess || p.splits == p.cluster) return err;
  const int quads = p.channels * p.height * p.width / 4;
  return launch(add_slices_bwd_kernel<T>, dim3((quads + kThreads - 1) / kThreads, p.batch), kThreads, 0, 1, true, s,
                p);
}

// The whole backward (the header's three lines) for one form.
template <typename T>
int mdblock_bwd(const T* g, const T* x, const T* y, const T* h1, const T* taps1, const T* taps2, const float* aff,
                T* gr, T* gm1, float* partial, T* dx, int batch, int channels, int height, int width,
                int n_branches, const int* dilations, int sub_tiles, int tile_channels, int stages, int halo_buffers,
                int splits, int cluster, cudaStream_t s) {
  const int hw = height * width;
  if (n_branches < 1 || n_branches > kMaxBranches || channels % 16 || hw % kTileP || batch < 1 ||
      (sub_tiles != 1 && !(sub_tiles == 2 && !kF32<T>)) || stages < 3 || stages > kMaxStages ||
      (tile_channels != 128 && !(tile_channels == 256 && sub_tiles == 2)) ||
      (halo_buffers != 1 && halo_buffers != 2) || cluster < 1 || cluster > 8 || splits % cluster ||
      (splits > 1 && sub_tiles != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Bwd<T> p{};
  p.branches.n = n_branches;
  for (int b = 0; b < kMaxBranches; ++b) {
    p.branches.dilation[b] = b < n_branches ? dilations[b] : 0;
    if (b < n_branches && dilations[b] > p.radius) p.radius = dilations[b];
  }
  if (smem_bytes<T>(sub_tiles, tile_channels, stages, halo_buffers, p.radius) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  p.batch = batch;
  p.channels = channels;
  p.height = height;
  p.width = width;
  p.patches_x = (width + 7) / 8;
  p.patches = batch * p.patches_x * ((height + 7) / 8);
  p.units = (channels * static_cast<int>(sizeof(T)) + 127) / 128 * 9 * n_branches;
  p.splits = splits;
  p.cluster = cluster;
  p.stages = stages;
  p.halo_buffers = halo_buffers;
  p.partial = partial;
  p.aff = aff;
  p.grad = g;
  p.y = y;

  const dim3 prologue_grid(hw / kTileP, (channels + 63) / 64, batch);
  if constexpr (kF32<T>)
    bwd_prologue_kernel<<<prologue_grid, kThreads, 0, s>>>(g, y, aff + 4 * channels, gr, channels, hw);
  else
    bwd_prologue_bf16_kernel<<<prologue_grid, kThreads, 0, s>>>(g, y, aff + 4 * channels, gr, channels, hw);
  cudaError_t err = cudaGetLastError();
  for (int mode = 1; mode <= 2 && err == cudaSuccess; ++mode) {
    // MDCL2^T of g_r into g_m1's pair, then MDCL1^T of g_m1 into dx
    p.mode = mode;
    p.out = mode == 1 ? gm1 : dx;
    p.mask = mode == 1 ? h1 : x;
    const T* in = mode == 1 ? gr : gm1;
    const T* taps = mode == 1 ? taps2 : taps1;
    if constexpr (kF32<T>)
      err = launch_mdcl<T, 1, 128>(p, in, taps, s);
    else if (sub_tiles == 2)
      err = tile_channels == 256 ? launch_mdcl<T, 2, 256>(p, in, taps, s) : launch_mdcl<T, 2, 128>(p, in, taps, s);
    else
      err = launch_mdcl<T, 1, 128>(p, in, taps, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// x's gradient of npe_mdblock (mdblock.cu) and npe_mdblock_bf16
// (mdblock_bf16.cu): g (y's cotangent), x, y, dx: (batch, channels, height,
// width) NCHW in the form's type (float32; bf16); h1: the forward's h1
// scratch (float32 NCHW; bf16 pixel-major); taps1, taps2: (9 * n_branches,
// channels, channels) as (tap, in, out); aff: (6, channels) float32, rows s0,
// t0, s1, t1, s2, t2; gr, gm1: scratch of twice x's size (the operand pairs of
// g_r and g_m1, pixel-major, the lo images after the hi); partial: float32
// scratch (batch, splits / cluster, channels * height * width), unused when
// splits == cluster; dilations: host array of n_branches <= 8 ints; the plan,
// as the wrapper's `bwd_plan` gives it: sub_tiles (1, or 2 patches a block in
// bf16 with one slice), tile_channels (128, or 256 with two patches a
// block), stages (3..8 tap stages), halo_buffers (2; 1 in bf16
// where two do not fit), splits (slices of the units) and cluster (1..8
// blocks dividing splits). channels a multiple of 16, height * width of 64.
// All device tensors contiguous and 16-byte aligned. 3 to 5 launches on
// `stream`; returns the first CUDA error code (0 = all launched).
extern "C" int npe_mdblock_bwd(const void* g, const void* x, const void* y, const void* h1, const void* taps1,
                               const void* taps2, const void* aff, void* gr, void* gm1, void* partial, void* dx,
                               int batch, int channels, int height, int width, int n_branches, const int* dilations,
                               int sub_tiles, int tile_channels, int stages, int halo_buffers, int splits,
                               int cluster, void* stream) {
  if (halo_buffers != 2) return static_cast<int>(cudaErrorInvalidValue);  // the float32 consumer splits ahead
  return mdblock_bwd(static_cast<const float*>(g), static_cast<const float*>(x), static_cast<const float*>(y),
                     static_cast<const float*>(h1), static_cast<const float*>(taps1),
                     static_cast<const float*>(taps2), static_cast<const float*>(aff), static_cast<float*>(gr),
                     static_cast<float*>(gm1), static_cast<float*>(partial), static_cast<float*>(dx), batch,
                     channels, height, width, n_branches, dilations, sub_tiles, tile_channels, stages, halo_buffers,
                     splits, cluster, static_cast<cudaStream_t>(stream));
}

extern "C" int npe_mdblock_bwd_bf16(const void* g, const void* x, const void* y, const void* h1, const void* taps1,
                                    const void* taps2, const void* aff, void* gr, void* gm1, void* partial, void* dx,
                                    int batch, int channels, int height, int width, int n_branches,
                                    const int* dilations, int sub_tiles, int tile_channels, int stages,
                                    int halo_buffers, int splits, int cluster, void* stream) {
  return mdblock_bwd(static_cast<const bf16*>(g), static_cast<const bf16*>(x), static_cast<const bf16*>(y),
                     static_cast<const bf16*>(h1), static_cast<const bf16*>(taps1), static_cast<const bf16*>(taps2),
                     static_cast<const float*>(aff), static_cast<bf16*>(gr), static_cast<bf16*>(gm1),
                     static_cast<float*>(partial), static_cast<bf16*>(dx), batch, channels, height, width,
                     n_branches, dilations, sub_tiles, tile_channels, stages, halo_buffers, splits, cluster,
                     static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` MDCL^T blocks of one patch and 128 channels
// (the only blocks a plan with slices takes; the form `bf16_form`, `stages`,
// `halo_buffers`, `radius`) the device holds at once; negative: a CUDA error
// code. For the scripts that measure `CLUSTER_SLOTS` in mdblock.py.
extern "C" int npe_mdblock_bwd_clusters(int bf16_form, int stages, int halo_buffers, int radius, int cluster) {
  int n = 0;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  config.gridDim = dim3(1, cluster);
  config.blockDim = dim3(160);
  config.attrs = &attr;
  config.numAttrs = 1;
  auto count = [&](auto kernel, int bytes) {
    config.dynamicSmemBytes = bytes;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return err == cudaSuccess ? cudaOccupancyMaxActiveClusters(&n, kernel, &config) : err;
  };
  const cudaError_t err = bf16_form
      ? count(mdcl_bwd_kernel<bf16, 1, 128>, smem_bytes<bf16>(1, 128, stages, halo_buffers, radius))
      : count(mdcl_bwd_kernel<float, 1, 128>, smem_bytes<float>(1, 128, stages, halo_buffers, radius));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
