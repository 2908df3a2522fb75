// mdblock_bf16: the inference MDBLOCK in bfloat16, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// npe_tpu/ops/pallas/mdcl_kernels.py:mdblock_fused (body `_kernel`, tap sum
// `_mdcl_sum`) given bf16 activations and taps:
//
//   y = lrelu(s2 * (x + MDCL2(lrelu(s1 * MDCL1(lrelu(s0 * x + t0)) + t1))) + t2)
//   MDCL(h)[co, p] = sum_t sum_ci h[ci, p + offset_t] * taps[t, ci, co]
//
// with batch norm folded to float32 per-channel affines (s, t), lrelu of
// slope 0.2, h zero outside the image, and the offsets those of a 3x3 at
// dilation 1 followed by one 3x3 per dilated scale. npe_tpu's kernel is
// dtype-generic, and in bf16 it rounds at three points: it widens x to
// float32, applies the affines and lrelus in float32, rounds each MDCL's
// input to bf16 just before its products (`mdcl_kernels.py:88`, and `:71`
// in `_mdcl_sum`), adds the products in float32, forms x + h in float32 and
// rounds the output. This kernel rounds at the same three points. The
// float32 form is mdblock.cu (3xTF32); this file is the bf16 form alone.
//
// Bound. An MDCL is an implicit GEMM of M = pixels by N = C out of K = T * C
// (T = 18 taps at 8x8x512, 27 at 16x16x256 and 32x32x128). At batch 128 a
// block is 77 to 116 GFLOP, 0.157 to 0.237 ms at 989 TFLOP/s; at one image
// the two tap tensors' bytes (19 MB at 8x8x512) or the fixed costs bound it.
//
// Design, in the order the work goes:
// 1. A prologue launch computes MDCL1's input once per element,
//    a = bf16(lrelu(s0 * x + t0)), and writes it pixel-major (NHWC: the
//    channels of a pixel contiguous) into a scratch map. The rounding point
//    is npe_tpu's, so this is exact, not an approximation. MDCL1 writes h1
//    = bf16(lrelu(s1 * sum + t1)) pixel-major too (npe_tpu rounds h1 there);
//    MDCL2 reads it and writes the NCHW output after the residual.
// 2. The products are wgmma.mma_async m64nNk16, bf16 operands and float32
//    sums, both operands read from shared memory through descriptors in the
//    layout without swizzle: core matrices of 8 rows x 16 bytes, 128
//    contiguous bytes each, so reads hit 32 distinct banks. A warpgroup's M
//    of 64 pixels is one 8x8 patch of the image (A K-major: a pixel's
//    channels contiguous); N is 128 output channels, or 256 (wgmma's
//    widest, half the instructions a multiply-add) where the plan takes two
//    patches a block and C >= 256. The taps are read as they lie, (T, C_in,
//    C_out): B is MN-major (wgmma's transpose flag), a core matrix 8 input
//    x 8 output channels, so no repacked copy of the taps is made.
// 3. A stage is one tap by 64 input channels: four k16 products a
//    warpgroup between barriers. Operands reach shared memory only through
//    the tensor memory accelerator, never through registers: one thread arms
//    a stage's mbarrier with the bytes to come and asks for the tap tile as
//    one 4-D box of the taps viewed as (8 output channels, 8 input channels,
//    output runs, input groups), which lands as wgmma's core matrices, and
//    for each patch's halo tile (below) as one 5-D box of the pixel-major
//    map; the boxes' out-of-range fill gives the zeros outside the image and
//    past C. The tensor maps are encoded on the host on every call (the
//    driver's encoder, looked up through the runtime). A ring of four tap
//    stages (16 or 32 KB), the copies two stages ahead, one group of
//    products in flight; a block barrier a stage keeps a stage from being
//    refilled before both warpgroups' products have read it.
// 4. Reuse across taps. For each 64-channel chunk the block stages one halo
//    tile per 8x8 patch: (8 + 2R)^2 pixels, R the largest dilation, laid out
//    as [16-byte channel group][halo pixel]. Every tap of every branch then
//    reads its shifted 8x8 window of that tile by the descriptor alone: the
//    start address moves by the tap's offset, the 8-row groups (image rows)
//    are one halo row apart (SBO), the channel groups one plane apart (LBO).
//    The activations are staged once per chunk instead of once per tap: 9x
//    fewer per branch, 18-27x fewer per block at full IAN's shapes. Two halo
//    buffers alternate by chunk.
// 5. Tiles by batch (the wrapper's `bf16_plan`, a pure function): with
//    enough output tiles to give every SM two, a block of two warpgroups
//    takes two patches over the same tap stages, which halves the taps'
//    traffic from L2; otherwise one warpgroup a block, two blocks an SM
//    where their shared memory fits (R = 2; at R = 3 one, by 32 bytes). A
//    map whose sides are not multiples of 8, or whose halo would not fit,
//    takes rows mode: 64 consecutive pixels a tile, its shifted window
//    copied per tap by every thread with cp.async (no reuse).
// 6. Batch 1 (the editor's shape, 4 to 16 output tiles for 132 SMs): the
//    inner dimension (chunks x taps, chunk-major so a slice keeps its halo)
//    is cut into slices over blockIdx.y; each writes float32 partial sums
//    in the output's layout and a second launch adds them in a fixed order
//    and applies the epilogue (deterministic, no atomics). With one slice the
//    epilogue runs in the product kernel. A block takes at least four units.
//
// The input gradient (npe_tpu's `_fused_bwd`) is mdblock_bwd.cu's, a kernel
// of its own on the same tiles.
//
// Accuracy. The sums stay in wgmma's float32 accumulators over the whole
// slice (up to 576 k16 products at 8x8x512). The tensor cores truncate the
// bits of a sum that fall below its largest term, which the float32 form
// (mdblock.cu) must avoid to keep float32 parity; here the drift is about
// 576 float32 ulps of the sum at most, some 1e-4 relative against the
// 1.2e-2 of the bf16 rule that chip_smoke.py holds this kernel to (three
// 2^-8 steps of |want| + std). Measured at 8x8x512, batch 128, the worst
// element reaches about half of that rule, as at one image (PERF.md).
//
// What bounds it (PERF.md has the times). At batch 128 it runs at 20-25 %
// of the bf16 operation bound. Variants timed on the card: the products
// alone (no copies, no barriers) reach about 40 % of the tensor cores'
// peak; the first form, every thread copying the tap tiles with 16-byte
// cp.async, was 15-25 % slower than the tensor copies; a 128-byte swizzle
// of either operand, an 8x8 window aligned to 128 bytes, and blocks that
// start at different chunks and taps (against L2 hot spots) each changed the
// time by less than the spread between calls. Left for a later change: a
// stage released by an mbarrier per warpgroup instead of the block barrier,
// and more product groups in flight (mdblock_bwd.cu's input gradient has
// both).
//
// Rejected: staying on mma.sync (the form this file replaces, 76a5cfd's
// mdblock.cu template, staged float32 planes and packed bf16 pairs at every
// fragment load, at 21x its bound at batch 128);
// a swizzled layout for the halo (a window starts at any pixel, which a
// swizzle's 1 KB atoms would forbid, and a swizzle measured no faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "dynamic_smem.cuh"
#include "tma.cuh"

namespace {

using namespace npe;
using bf16 = __nv_bfloat16;

constexpr int kKc = 64;                   // input channels of a chunk (a stage)
constexpr int kGroups = kKc / 8;          // its 16-byte channel groups
constexpr int kTileP = 64;                // pixels of a patch: a warpgroup's M
constexpr int kStages = 4;                // the tap ring
constexpr int kAhead = 2;                 // units whose copies fly ahead of the products
constexpr int kRowsStage = kTileP * kKc * 2;  // bytes of a rows-mode activation stage, 8 KB
constexpr int kMaxBranches = 8;
constexpr int kThreads = 256;             // the prologue's and add_slices' blocks

struct Branches {
  int n;
  int dilation[kMaxBranches];
};

// One MDCL launch.
struct Mdcl {
  const bf16* in;        // (batch, height, width, channels): the MDCL's input, activated, bf16
  const bf16* taps;      // (9 * branches.n, channels in, channels out)
  Branches branches;
  int channels, height, width, patches;  // patches: batch * height * width / 64
  int radius;            // halo mode: the largest dilation
  int units, splits;     // units: chunks x taps
  float* partial;        // splits > 1: partial sums (batch, splits, ...) in the output's layout
  bf16* out;             // splits == 1: the finished map
  const float* aff_out;  // rows (s, t) of the epilogue
  const bf16* resid;     // NCHW, added before the epilogue's affine; or null
  int pixel_major;       // the output's layout: NHWC (h1), else NCHW
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

// 16 bytes from global to shared memory, asynchronously; zeros if !ok.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// bf16 activations of a prologue: lrelu(s * x + t) rounded to bf16, NCHW in,
// pixel-major out. A block turns a 64-channel x 64-pixel tile of one image.
__global__ void __launch_bounds__(kThreads)
prologue_kernel(const bf16* __restrict__ x, const float* __restrict__ aff, bf16* __restrict__ act, int channels,
                int hw) {
  __shared__ float tile[kKc][kTileP + 1];  // [channel][pixel]
  const int p0 = blockIdx.x * kTileP, c0 = blockIdx.y * kKc;
  const size_t n = blockIdx.z;
  for (int i = threadIdx.x; i < kKc * kTileP / 8; i += kThreads) {
    const int c = i / 8, g = i % 8;
    if (c0 + c >= channels) continue;
    float v[8];
    npe::bf16x8_to_f32(*reinterpret_cast<const uint4*>(x + (n * channels + c0 + c) * hw + p0 + 8 * g), v);
    const float s = __ldg(aff + c0 + c), t = __ldg(aff + channels + c0 + c);
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[c][8 * g + k] = lrelu(fmaf(s, v[k], t));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kKc * kTileP / 8; i += kThreads) {
    const int p = i / kGroups, g = i % kGroups;
    if (c0 + 8 * g >= channels) continue;
    uint32_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(tile[8 * g + 2 * k][p], tile[8 * g + 2 * k + 1][p]);
      q[k] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(act + (n * hw + p0 + p) * channels + c0 + 8 * g) = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// One MDCL over the slice blockIdx.y of its units, kSub warpgroups a block,
// each with its own 64-pixel patch, over one tile of kN output channels.
// kHalo: patches are 8x8 squares with a halo tile a chunk; else 64
// consecutive pixels with their window staged per tap. A unit is (chunk,
// tap).
template <int kSub, bool kHalo, int kN>
__device__ __forceinline__ void mdcl_tile(const Mdcl& p, const CUtensorMap* taps_map, const CUtensorMap* act_map) {
  constexpr int kTapStage = kKc * kN * 2;  // bytes of a tap stage: 16 or 32 KB
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int channels = p.channels, height = p.height, width = p.width, hw = height * width;
  const int tiles_c = (channels + kN - 1) / kN;
  const int tile_c = blockIdx.x % tiles_c, n0 = tile_c * kN;
  const int group = blockIdx.x / tiles_c, split = blockIdx.y;
  const int n_taps = 9 * p.branches.n;
  const int first = static_cast<int>(static_cast<long long>(split) * p.units / p.splits);
  const int last = static_cast<int>(static_cast<long long>(split + 1) * p.units / p.splits);
  const int first_chunk = first / n_taps;
  const int radius = kHalo ? p.radius : 0;
  const int halo_w = kTileP / 8 + 2 * radius, halo_px = halo_w * halo_w;
  const int a_bytes = kHalo ? halo_px * kKc * 2 : kRowsStage;
  uint8_t* const taps_s = smem;
  uint8_t* const act_s = smem + kStages * kTapStage;  // kHalo: [sub][2][a_bytes]; else [sub][kStages][a_bytes]
  // one barrier a stage, after the activations
  const uint32_t bars = smem_addr(act_s + kSub * (kHalo ? 2 : kStages) * a_bytes);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) barrier_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each patch of the block: its image, and its first pixel (rows) or its
  // top-left corner (halo).
  int img[kSub], py0[kSub], px0[kSub];
  bool valid[kSub];
  const int per_image = hw / kTileP;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int idx = group * kSub + s;
    valid[s] = idx < p.patches;
    img[s] = valid[s] ? idx / per_image : 0;
    const int t = idx % per_image;
    if constexpr (kHalo) {
      py0[s] = 8 * (t / (width / 8));
      px0[s] = 8 * (t % (width / 8));
    } else {
      py0[s] = kTileP * t;  // the first pixel, row-major
      px0[s] = 0;
    }
  }

  // The copies of unit u into stage (u - first) % kStages. One thread arms
  // the stage's barrier and asks the tensor memory accelerator for the tap
  // tile (one box: 8 input-channel groups x kN / 8 runs of 8 output channels
  // x 8 input channels x 8 output channels, laid out as wgmma's MN-major
  // core matrices; output channels past C are zeros) and, when u starts a
  // chunk (or the slice), for each patch's halo tile (one box: 8 channel
  // groups x (8 + 2R)^2 pixels x 8 channels, zeros outside the image). In
  // rows mode every thread copies the shifted windows with cp.async.
  auto issue = [&](int u) {
    const int chunk = u / n_taps, t = u - chunk * n_taps;
    const int c0 = chunk * kKc;
    const int stage = (u - first) % kStages;
    const bool halo_load = kHalo && (t == 0 || u == first);
    if (tid == 0) {
      const uint32_t bar = bars + 8 * stage;
      int patches_loaded = 0;
#pragma unroll
      for (int s = 0; s < kSub; ++s) patches_loaded += halo_load && valid[s];
      barrier_expect(bar, kTapStage + patches_loaded * a_bytes);
      tensor_copy_4d(smem_addr(taps_s + stage * kTapStage), taps_map, 0, 0, n0 / 8, (t * channels + c0) / 8, bar);
      if (halo_load) {
        const int buf = (chunk - first_chunk) & 1;
#pragma unroll
        for (int s = 0; s < kSub; ++s)
          if (valid[s])
            tensor_copy_5d(smem_addr(act_s + (2 * s + buf) * a_bytes), act_map, 0, px0[s] - radius, py0[s] - radius,
                           c0 / 8, img[s], bar);
      }
    }
    if constexpr (!kHalo) {
      // The windows: 16-byte channel groups g of pixels; eight threads take
      // eight neighbouring pixels of one group (128 contiguous bytes of
      // shared memory), the warp four groups of each (64 contiguous bytes).
      const int groups = min(kGroups, (channels - c0) / 8);
      const int dil = p.branches.dilation[t / 9];
      const int dy = (t % 9 / 3 - 1) * dil, dx = (t % 3 - 1) * dil;
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const uint32_t dst = smem_addr(act_s + (kStages * s + stage) * a_bytes);
        for (int i = tid; i < kTileP * groups; i += 128 * kSub) {
          const int g = (i >> 3) % groups, r = 8 * ((i >> 3) / groups) + (i & 7);
          const int y = (py0[s] + r) / width + dy, x = (py0[s] + r) % width + dx;
          const bool ok = valid[s] && y >= 0 && y < height && x >= 0 && x < width;
          const bf16* src = p.in + ((static_cast<size_t>(img[s]) * height + (ok ? y : 0)) * width + (ok ? x : 0)) *
                                       channels + c0 + 8 * g;
          copy16(dst + (g * kTileP + r) * 16, src, ok);
        }
      }
    }
  };

  float acc[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = 0.0f;

#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (first + j < last) issue(first + j);
    copies_commit();
  }
  for (int u = first; u < last; ++u) {
    const int stage = (u - first) % kStages;
    barrier_wait(bars + 8 * stage, ((u - first) / kStages) & 1);  // the tensor copies of unit u have landed
    if constexpr (!kHalo) {
      copies_wait<kAhead - 1>();  // this thread's copies of unit u have landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's reads
    }
    __syncthreads();  // everyone's have; and every product of unit u - 2 is done
    if (u + kAhead < last) issue(u + kAhead);
    copies_commit();

    const int chunk = u / n_taps, t = u - chunk * n_taps;
    const int steps = min(kKc, channels - chunk * kKc) / 16;
    const uint32_t b = smem_addr(taps_s + stage * kTapStage);
    uint32_t a, lbo_a, sbo_a;
    if constexpr (kHalo) {
      const int dil = p.branches.dilation[t / 9];
      const int dy = (t % 9 / 3 - 1) * dil, dx = (t % 3 - 1) * dil;
      a = smem_addr(act_s + (2 * wg + ((chunk - first_chunk) & 1)) * a_bytes) +
          ((dy + radius) * halo_w + dx + radius) * 16;
      lbo_a = halo_px * 16;
      sbo_a = halo_w * 16;
    } else {
      a = smem_addr(act_s + (kStages * wg + stage) * a_bytes);
      lbo_a = kTileP * 16;
      sbo_a = 8 * 16;
    }
    auto product = [&](int j) {
      wgmma_bf16<kN, 1>(acc, descriptor(a + 2 * j * lbo_a, lbo_a, sbo_a), descriptor(b + 2 * j * (kN * 16), kN * 16, 128));
    };
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (steps == kKc / 16) {  // a whole chunk: straight-line products
#pragma unroll
      for (int j = 0; j < kKc / 16; ++j) product(j);
    } else {
      for (int j = 0; j < steps; ++j) product(j);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  copies_wait<0>();
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) asm volatile("" : "+f"(acc[e])::"memory");

  // acc[4 j + q] is row 16 w + grp (+ 8 for q >= 2), channel 8 j + 2 tig
  // (+ 1 for odd q) of the warpgroup's 64 x kN tile, w its warp.
  if (!valid[wg]) return;
  const int lane = tid % 32, w = (tid % 128) / 32, grp = lane / 4, tig = lane % 4;
  const size_t image = p.splits > 1 ? static_cast<size_t>(img[wg]) * p.splits + split : img[wg];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 16 * w + grp + 8 * half;
    const int pix = kHalo ? (py0[wg] + m / 8) * width + px0[wg] + m % 8 : py0[wg] + m;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int co = n0 + 8 * j + 2 * tig;
      if (co >= channels) continue;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (p.splits > 1) {
        if (p.pixel_major) {
          *reinterpret_cast<float2*>(p.partial + (image * hw + pix) * channels + co) = make_float2(v0, v1);
        } else {
          p.partial[(image * channels + co) * hw + pix] = v0;
          p.partial[(image * channels + co + 1) * hw + pix] = v1;
        }
        continue;
      }
      const float s0 = __ldg(p.aff_out + co), t0 = __ldg(p.aff_out + channels + co);
      const float s1 = __ldg(p.aff_out + co + 1), t1 = __ldg(p.aff_out + channels + co + 1);
      if (p.pixel_major) {
        *reinterpret_cast<__nv_bfloat162*>(p.out + (image * hw + pix) * channels + co) =
            __floats2bfloat162_rn(lrelu(fmaf(s0, v0, t0)), lrelu(fmaf(s1, v1, t1)));
      } else {
        const size_t at0 = (image * channels + co) * hw + pix, at1 = at0 + hw;
        if (p.resid != nullptr) {
          v0 += __bfloat162float(p.resid[at0]);
          v1 += __bfloat162float(p.resid[at1]);
        }
        p.out[at0] = __float2bfloat16_rn(lrelu(fmaf(s0, v0, t0)));
        p.out[at1] = __float2bfloat16_rn(lrelu(fmaf(s1, v1, t1)));
      }
    }
  }
}

// p is __grid_constant__ because mdcl_tile takes it by reference: without it
// the compiler may copy the parameter to the stack, and how depends on the
// struct's size (a 120-byte stack frame and 0.047 against 0.040 ms at
// 8x8x512, batch 1, on an H100).
template <int kSub, bool kHalo, int kN>
__global__ void __launch_bounds__(128 * kSub, 1)
mdcl_kernel(const __grid_constant__ Mdcl p, const __grid_constant__ CUtensorMap taps_map,
            const __grid_constant__ CUtensorMap act_map) {
  mdcl_tile<kSub, kHalo, kN>(p, &taps_map, &act_map);
}

// out[i] = bf16(lrelu(s[c] * (sum over the slices, in order, of partial[slice, i]
// [+ resid[i]]) + t[c])) for the elements i of image blockIdx.y, four a thread;
// c from the layout (pixel-major: i % channels; else i / hw).
__global__ void __launch_bounds__(kThreads)
add_slices_kernel(const float* __restrict__ partial, const float* __restrict__ aff_out,
                  const bf16* __restrict__ resid, bf16* __restrict__ out, int splits, int channels, int hw,
                  int pixel_major) {
  const int per_image = channels * hw;
  const int i = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (i >= per_image) return;
  const float* src = partial + static_cast<size_t>(blockIdx.y) * splits * per_image + i;
  float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
  for (int k = 1; k < splits; ++k) {
    const float4 q = *reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * per_image);
    v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
  }
  const size_t at = static_cast<size_t>(blockIdx.y) * per_image + i;
  if (resid != nullptr) {
    const float4 r = npe::load4(resid + at);
    v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
  }
  float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = pixel_major ? (i + k) % channels : i / hw;
    e[k] = lrelu(fmaf(__ldg(aff_out + c), e[k], __ldg(aff_out + channels + c)));
  }
  npe::store4(out + at, make_float4(e[0], e[1], e[2], e[3]));
}

// The tap tiles, the activations of a patch's halo, then a barrier a stage.
int smem_bytes(int sub, bool halo, int radius, int tile_n) {
  const int halo_w = kTileP / 8 + 2 * radius;
  return kStages * kKc * tile_n * 2 + sub * (halo ? 2 * halo_w * halo_w * kKc * 2 : kStages * kRowsStage) +
         kStages * 8;
}

template <int kSub, bool kHalo, int kN>
cudaError_t launch_mdcl(const Mdcl& p, int batch, cudaStream_t s) {
  const int tiles = (p.patches + kSub - 1) / kSub * ((p.channels + kN - 1) / kN);
  const int bytes = smem_bytes(kSub, kHalo, p.radius, kN);
  const cuuint64_t c = p.channels, rows = 9ull * p.branches.n * p.channels;
  CUtensorMap taps_map{}, act_map{};
  // taps (T * C rows of C): (8 outputs, 8 inputs, C / 8 output runs, T * C / 8 input groups)
  const cuuint64_t taps_dims[4] = {8, 8, c / 8, rows / 8};
  const cuuint64_t taps_strides[3] = {2 * c, 16, 16 * c};
  const cuuint32_t taps_box[4] = {8, 8, kN / 8, 8};
  cudaError_t err = tensor_map(&taps_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.taps, 4, taps_dims, taps_strides,
                               taps_box);
  if (err == cudaSuccess && kHalo) {
    // the pixel-major input: (8 channels, width, height, C / 8 groups, batch)
    const cuuint64_t w = p.width, h = p.height;
    const cuuint64_t act_dims[5] = {8, w, h, c / 8, static_cast<cuuint64_t>(batch)};
    const cuuint64_t act_strides[4] = {2 * c, 2 * c * w, 16, 2 * c * w * h};
    const cuuint32_t side = kTileP / 8 + 2 * p.radius;
    const cuuint32_t act_box[5] = {8, side, side, kGroups, 1};
    err = tensor_map(&act_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.in, 5, act_dims, act_strides, act_box);
  }
  if (err == cudaSuccess) err = npe::allow_dynamic_smem<mdcl_kernel<kSub, kHalo, kN>>(bytes);
  if (err != cudaSuccess) return err;
  mdcl_kernel<kSub, kHalo, kN><<<dim3(tiles, p.splits), 128 * kSub, bytes, s>>>(p, taps_map, act_map);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int quads = p.channels * p.height * p.width / 4;
  add_slices_kernel<<<dim3((quads + kThreads - 1) / kThreads, batch), kThreads, 0, s>>>(
      p.partial, p.aff_out, p.resid, p.out, p.splits, p.channels, p.height * p.width, p.pixel_major);
  return cudaGetLastError();
}

// The kernel for a plan: 256-channel tiles only with two patches a block.
cudaError_t mdcl(Mdcl p, int batch, int sub, bool halo, int tile_n, cudaStream_t s) {
  if (sub == 2 && tile_n == 256)
    return halo ? launch_mdcl<2, true, 256>(p, batch, s) : launch_mdcl<2, false, 256>(p, batch, s);
  if (sub == 2)
    return halo ? launch_mdcl<2, true, 128>(p, batch, s) : launch_mdcl<2, false, 128>(p, batch, s);
  return halo ? launch_mdcl<1, true, 128>(p, batch, s) : launch_mdcl<1, false, 128>(p, batch, s);
}

// The checks and the plan's fields; false if the arguments are not a plan's.
bool plan_mdcl(Mdcl& p, int batch, int channels, int height, int width, int n_branches,
               const int* dilations, int sub_tiles, int halo, int tile_channels, int splits, void* partial) {
  const int hw = height * width;
  if (n_branches < 1 || n_branches > kMaxBranches || channels % 16 || hw % kTileP || (sub_tiles != 1 && sub_tiles != 2) ||
      (halo && (height % 8 || width % 8)) || splits < 1 ||
      (tile_channels != 128 && !(tile_channels == 256 && sub_tiles == 2)))
    return false;
  p = Mdcl{};
  p.branches.n = n_branches;
  p.radius = 0;
  for (int b = 0; b < kMaxBranches; ++b) {
    p.branches.dilation[b] = b < n_branches ? dilations[b] : 0;
    if (b < n_branches && dilations[b] > p.radius) p.radius = dilations[b];
  }
  if (smem_bytes(sub_tiles, halo != 0, p.radius, tile_channels) > 227 * 1024) return false;
  p.channels = channels;
  p.height = height;
  p.width = width;
  p.patches = batch * hw / kTileP;
  p.units = (channels + kKc - 1) / kKc * 9 * n_branches;
  p.splits = splits;
  p.partial = static_cast<float*>(partial);
  return true;
}

}  // namespace

// x, out: (batch, channels, height, width) bf16 NCHW, channels a multiple of
// 16 and height*width a multiple of 64; taps1, taps2: (9 * n_branches,
// channels, channels) bf16 as (tap, in, out); aff: (6, channels) float32, rows s0, t0, s1, t1,
// s2, t2; act, h1: scratch bf16 of x's size (MDCL1's input and h1,
// pixel-major); partial: scratch float32 (batch, splits, channels * height *
// width), unused when splits is 1; dilations: host array of n_branches <= 8
// ints; sub_tiles 1 or 2 patches a block; halo 1 for 8x8 patches with halo
// tiles (height and width multiples of 8), else 0; tile_channels 128, or 256
// with two patches a block: output channels a block; splits >= 1 slices of the
// units (ceil(channels / 64) * 9 * n_branches), as the wrapper's `bf16_plan`
// gives them. All device tensors contiguous and 16-byte aligned. Three to
// five launches on `stream`; returns the first CUDA error code (0 = all
// launched).
extern "C" int npe_mdblock_bf16(const void* x, const void* taps1, const void* taps2, const void* aff, void* act,
                                void* h1, void* partial, void* out, int batch, int channels, int height, int width,
                                int n_branches, const int* dilations, int sub_tiles, int halo,
                                int tile_channels, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = height * width;
  Mdcl p;
  if (!plan_mdcl(p, batch, channels, height, width, n_branches, dilations, sub_tiles, halo, tile_channels,
                 splits, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* af = static_cast<const float*>(aff);

  prologue_kernel<<<dim3(hw / kTileP, (channels + kKc - 1) / kKc, batch), kThreads, 0, s>>>(
      xb, af, static_cast<bf16*>(act), channels, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  p.in = static_cast<const bf16*>(act);
  p.taps = static_cast<const bf16*>(taps1);
  p.out = static_cast<bf16*>(h1);
  p.aff_out = af + 2 * channels;
  p.resid = nullptr;
  p.pixel_major = 1;
  err = mdcl(p, batch, sub_tiles, halo != 0, tile_channels, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  p.in = static_cast<const bf16*>(h1);
  p.taps = static_cast<const bf16*>(taps2);
  p.out = static_cast<bf16*>(out);
  p.aff_out = af + 4 * channels;
  p.resid = xb;
  p.pixel_major = 0;
  return static_cast<int>(mdcl(p, batch, sub_tiles, halo != 0, tile_channels, s));
}
