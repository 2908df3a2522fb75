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
// The input gradient (npe_tpu's `_fused_bwd`, the VJP of the reference; the
// math is in mdblock.cu's header): g_r = s2 * lrelu'(a2) * g, then
// g_m1 = s1 * lrelu'(a1) * MDCL2^T(g_r), then
// dx = g_r + s0 * lrelu'(a0) * MDCL1^T(g_m1). MDCL^T is an MDCL over the same
// offsets whose tap t is taps[m(t)] transposed (m mirrors a branch's nine
// taps), so the backward runs the same product kernel (mdcl_bwd_kernel) and
// plan: the activations are halo tiles (or rows-mode windows) of g_r and
// g_m1, pixel-major bf16, and the tap tile is the box of rows ci (the
// tile's output channels) by 64 columns co of taps[m(t)] as they lie, which
// lands as wgmma's K-major B (no transpose flag); no copy of the taps is
// made. g_r and g_m1 are float32 values that the plain version's VJP never
// rounds, so each is fed to wgmma as a bf16 pair, hi = bf16(v) and
// lo = bf16(v - hi) (hi + lo holds v to about 16 bits), two products into
// the same float32 sums: the pair is stored as 2 * batch images, the lo
// halves after the hi, and a unit of the backward is (chunk, part, tap),
// so each tap tile is read twice, once a part (kParts in mdcl_tile). A
// prologue launch (bwd_prologue_bf16_kernel) writes g_r's pair pixel-major;
// MDCL2^T's epilogue writes g_m1's pair pixel-major, its sign of a1 read
// from the forward's h1 in the same layout; MDCL1^T's writes dx NCHW.
// Rounding points: those of the plain version's VJP in bf16 (each MDCL^T's
// sum rounded to bf16, as the cotangent of the rounded MDCL input; dx
// rounded once at the end; g_r in dx's sum stays float32, formed again from
// g and y) and the pairs' split. mdblock.py's `mdblock_backward_reference`
// does the same in PyTorch.
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
// and more product groups in flight (the backward runs the same loop,
// twice the products of the forward for its hi and lo operands).
//
// Rejected: staying on mma.sync (the form this file replaces, 76a5cfd's
// mdblock.cu template, staged float32 planes and packed bf16 pairs at every
// fragment load, at 21x its bound at batch 128);
// a swizzled layout for the halo (a window starts at any pixel, which a
// swizzle's 1 KB atoms would forbid, and a swizzle measured no faster).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "dynamic_smem.cuh"

namespace {

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
  int units, splits;     // units: chunks x parts x taps; parts 1, or the backward's 2 (`mdcl_tile`)
  float* partial;        // splits > 1: partial sums (batch, splits, ...) in the output's layout
  bf16* out;             // splits == 1: the finished map
  const float* aff_out;  // rows (s, t) of the epilogue
  const bf16* resid;     // NCHW, added before the epilogue's affine; or null
  int pixel_major;       // the output's layout: NHWC (h1), else NCHW
  // The backward (aff_out then the six rows of the affines): with pixel_major
  // the output is g_m1 and mask the forward's h1 (pixel-major), else dx and
  // mask x; grad and y (NCHW) give g_r again for dx.
  const bf16* mask;
  const bf16* grad;
  const bf16* y;
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

// lrelu'(a) * v: v where a > 0, else 0.2 v (0.2 at a = 0, as torch's VJP).
__device__ __forceinline__ float slope(float a, float v) { return a > 0.0f ? v : v * 0.2f; }

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The backward's operand pair of two neighbouring values: hi = bf16(v) at
// `hi`, lo = bf16(v - hi) `stride` elements on.
__device__ __forceinline__ void store_pair(bf16* hi, size_t stride, float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(hi + stride) =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
}

// The backward's epilogue of a finished sum v of channel c at element `at`
// (the output's layout): g_m1 = s1 * lrelu'(a1) * bf16(v), or
// dx = g_r + s0 * lrelu'(s0 * x + t0) * bf16(v) with
// g_r = s2 * lrelu'(a2) * g; the caller rounds it to bf16.
__device__ __forceinline__ float bwd_finish(const Mdcl& p, float v, size_t at, int c) {
  const int channels = p.channels;
  v = round_bf16(v);
  if (p.pixel_major) return slope(__bfloat162float(p.mask[at]), v) * __ldg(p.aff_out + 2 * channels + c);
  const float s0 = __ldg(p.aff_out + c);
  const float a0 = __fadd_rn(__fmul_rn(__bfloat162float(p.mask[at]), s0), __ldg(p.aff_out + channels + c));
  const float gr = slope(__bfloat162float(p.y[at]), __bfloat162float(p.grad[at])) * __ldg(p.aff_out + 4 * channels + c);
  return gr + slope(a0, v) * s0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// The stage barriers: the producer thread arms a stage's barrier with the
// bytes its copies will write, the tensor memory accelerator completes them.
__device__ __forceinline__ void barrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void barrier_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Waits for the barrier's phase `parity` to complete. A copy that never
// lands (a bad tensor map) traps after about a second instead of hanging.
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
  for (long long tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1ll << 22)) __trap();
  }
}

// Tensor copies into shared memory, completing on `bar`.
__device__ __forceinline__ void tensor_copy_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tensor_copy_5d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                               int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], "
      "[%7];\n" ::"r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// A wgmma descriptor: K-major, no swizzle; lbo the bytes between the two
// core matrices along K, sbo those between 8-row groups.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d += A * B: A 64 x 16 K-major, B 16 x kN MN-major (kTransB, transposed:
// eight output channels contiguous in a core matrix's row) or K-major, bf16
// in shared memory, float32 sums.
template <int kN, int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (kN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
  }
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

// The backward's first launch: g_r = s2 * lrelu'(a2) * g from g and y
// (NCHW), written pixel-major as its (hi, lo) pair, the lo images after the
// hi (`store_pair`); a block turns a 64-channel x 64-pixel tile of one
// image, as prologue_kernel.
__global__ void __launch_bounds__(kThreads)
bwd_prologue_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y, const float* __restrict__ s2,
                         bf16* __restrict__ gr, int channels, int hw) {
  const size_t lo = static_cast<size_t>(gridDim.z) * hw * channels;
  __shared__ float tile[kKc][kTileP + 1];  // [channel][pixel]
  const int p0 = blockIdx.x * kTileP, c0 = blockIdx.y * kKc;
  const size_t n = blockIdx.z;
  for (int i = threadIdx.x; i < kKc * kTileP / 8; i += kThreads) {
    const int c = i / 8, k8 = i % 8;
    if (c0 + c >= channels) continue;
    float gv[8], yv[8];
    const size_t at = (n * channels + c0 + c) * hw + p0 + 8 * k8;
    npe::bf16x8_to_f32(*reinterpret_cast<const uint4*>(g + at), gv);
    npe::bf16x8_to_f32(*reinterpret_cast<const uint4*>(y + at), yv);
    const float s = __ldg(s2 + c0 + c);
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[c][8 * k8 + k] = slope(yv[k], gv[k]) * s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kKc * kTileP / 8; i += kThreads) {
    const int p = i / kGroups, grp = i % kGroups;
    if (c0 + 8 * grp >= channels) continue;
    uint32_t q[4], r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v0 = tile[8 * grp + 2 * k][p], v1 = tile[8 * grp + 2 * k + 1][p];
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
      q[k] = *reinterpret_cast<const uint32_t*>(&h);
      r[k] = *reinterpret_cast<const uint32_t*>(&l);
    }
    bf16* const at = gr + (n * hw + p0 + p) * channels + c0 + 8 * grp;
    *reinterpret_cast<uint4*>(at) = make_uint4(q[0], q[1], q[2], q[3]);
    *reinterpret_cast<uint4*>(at + lo) = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// One MDCL over the slice blockIdx.y of its units, kSub warpgroups a block,
// each with its own 64-pixel patch, over one tile of kN output channels.
// kHalo: patches are 8x8 squares with a halo tile a chunk; else 64
// consecutive pixels with their window staged per tap. kBwd: MDCL^T, the
// tap tile of unit u that of the mirrored tap, K-major, and the backward's
// epilogue. A unit is (chunk, part, tap): with two parts the chunk's halo
// tile or window comes from image img + part * batch (the lo operands).
template <int kSub, bool kHalo, int kN, bool kBwd>
__device__ __forceinline__ void mdcl_tile(const Mdcl& p, const CUtensorMap* taps_map, const CUtensorMap* act_map) {
  constexpr int kTapStage = kKc * kN * 2;  // bytes of a tap stage: 16 or 32 KB
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int channels = p.channels, height = p.height, width = p.width, hw = height * width;
  const int tiles_c = (channels + kN - 1) / kN;
  const int tile_c = blockIdx.x % tiles_c, n0 = tile_c * kN;
  const int group = blockIdx.x / tiles_c, split = blockIdx.y;
  constexpr int kParts = kBwd ? 2 : 1;  // the backward's input: a (hi, lo) pair, the lo images after the hi
  const int n_taps = 9 * p.branches.n;
  const int first = static_cast<int>(static_cast<long long>(split) * p.units / p.splits);
  const int last = static_cast<int>(static_cast<long long>(split + 1) * p.units / p.splits);
  const int first_stretch = first / n_taps;  // a stretch: the taps of one (chunk, part)
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
  const int per_image = hw / kTileP, batch = p.patches / per_image;
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
    const int stretch = u / n_taps, t = u - stretch * n_taps;
    const int c0 = stretch / kParts * kKc, part = stretch % kParts;
    const int stage = (u - first) % kStages;
    const bool halo_load = kHalo && (t == 0 || u == first);
    if (tid == 0) {
      const uint32_t bar = bars + 8 * stage;
      int patches_loaded = 0;
#pragma unroll
      for (int s = 0; s < kSub; ++s) patches_loaded += halo_load && valid[s];
      barrier_expect(bar, kTapStage + patches_loaded * a_bytes);
      if constexpr (kBwd)  // (8 columns co, kN rows ci, the mirrored tap, 8 groups of columns)
        tensor_copy_4d(smem_addr(taps_s + stage * kTapStage), taps_map, 0, n0, 9 * (t / 9) + 8 - t % 9, c0 / 8, bar);
      else
        tensor_copy_4d(smem_addr(taps_s + stage * kTapStage), taps_map, 0, 0, n0 / 8, (t * channels + c0) / 8, bar);
      if (halo_load) {
        const int buf = (stretch - first_stretch) & 1;
#pragma unroll
        for (int s = 0; s < kSub; ++s)
          if (valid[s])
            tensor_copy_5d(smem_addr(act_s + (2 * s + buf) * a_bytes), act_map, 0, px0[s] - radius, py0[s] - radius,
                           c0 / 8, img[s] + part * batch, bar);
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
          const bf16* src = p.in + ((static_cast<size_t>(img[s] + part * batch) * height + (ok ? y : 0)) * width +
                                    (ok ? x : 0)) * channels + c0 + 8 * g;
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

    const int stretch = u / n_taps, t = u - stretch * n_taps;
    const int steps = min(kKc, channels - stretch / kParts * kKc) / 16;
    const uint32_t b = smem_addr(taps_s + stage * kTapStage);
    uint32_t a, lbo_a, sbo_a;
    if constexpr (kHalo) {
      const int dil = p.branches.dilation[t / 9];
      const int dy = (t % 9 / 3 - 1) * dil, dx = (t % 3 - 1) * dil;
      a = smem_addr(act_s + (2 * wg + ((stretch - first_stretch) & 1)) * a_bytes) +
          ((dy + radius) * halo_w + dx + radius) * 16;
      lbo_a = halo_px * 16;
      sbo_a = halo_w * 16;
    } else {
      a = smem_addr(act_s + (kStages * wg + stage) * a_bytes);
      lbo_a = kTileP * 16;
      sbo_a = 8 * 16;
    }
    auto product = [&](int j) {
      wgmma_bf16<kN, kBwd ? 0 : 1>(acc, descriptor(a + 2 * j * lbo_a, lbo_a, sbo_a), descriptor(b + 2 * j * (kN * 16), kN * 16, 128));
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
      if constexpr (kBwd) {
        if (p.pixel_major) {  // g_m1's pair
          const size_t at = (image * hw + pix) * channels + co;
          store_pair(p.out + at, static_cast<size_t>(batch) * hw * channels, bwd_finish(p, v0, at, co),
                     bwd_finish(p, v1, at + 1, co + 1));
        } else {
          const size_t at0 = (image * channels + co) * hw + pix, at1 = at0 + hw;
          p.out[at0] = __float2bfloat16_rn(bwd_finish(p, v0, at0, co));
          p.out[at1] = __float2bfloat16_rn(bwd_finish(p, v1, at1, co + 1));
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

template <int kSub, bool kHalo, int kN>
__global__ void __launch_bounds__(128 * kSub, 1)
mdcl_kernel(const Mdcl p, const __grid_constant__ CUtensorMap taps_map, const __grid_constant__ CUtensorMap act_map) {
  mdcl_tile<kSub, kHalo, kN, false>(p, &taps_map, &act_map);
}

// The backward's MDCL^T (g_r to g_m1, then g_m1 to dx).
template <int kSub, bool kHalo, int kN>
__global__ void __launch_bounds__(128 * kSub, 1)
mdcl_bwd_kernel(const Mdcl p, const __grid_constant__ CUtensorMap taps_map,
                const __grid_constant__ CUtensorMap act_map) {
  mdcl_tile<kSub, kHalo, kN, true>(p, &taps_map, &act_map);
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

// The backward's slice sums: out[i] = bwd_finish(sum over the slices, in
// order, of partial[slice, i]) for the elements i of image blockIdx.y, four
// a thread, in the output's layout (g_m1's pair pixel-major, dx NCHW in bf16).
__global__ void __launch_bounds__(kThreads)
add_slices_bwd_kernel(const Mdcl p) {
  const int hw = p.height * p.width, per_image = p.channels * hw;
  const int i = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (i >= per_image) return;
  const float* src = p.partial + static_cast<size_t>(blockIdx.y) * p.splits * per_image + i;
  float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
  for (int k = 1; k < p.splits; ++k) {
    const float4 q = *reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * per_image);
    v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
  }
  const size_t at = static_cast<size_t>(blockIdx.y) * per_image + i;
  float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = bwd_finish(p, e[k], at + k, p.pixel_major ? (i + k) % p.channels : i / hw);
  if (p.pixel_major) {
    const size_t lo = static_cast<size_t>(gridDim.y) * per_image;
    store_pair(p.out + at, lo, e[0], e[1]);
    store_pair(p.out + at + 2, lo, e[2], e[3]);
  } else {
    npe::store4(p.out + at, make_float4(e[0], e[1], e[2], e[3]));
  }
}

// The tap tiles, the activations of a patch's halo, then a barrier a stage.
int smem_bytes(int sub, bool halo, int radius, int tile_n) {
  const int halo_w = kTileP / 8 + 2 * radius;
  return kStages * kKc * tile_n * 2 + sub * (halo ? 2 * halo_w * halo_w * kKc * 2 : kStages * kRowsStage) +
         kStages * 8;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map over bf16 `base` without swizzle, zeros outside: `rank` dims
// of `dims` elements, dims 1.. `strides` bytes apart, boxes of `box`. The
// driver's encoder is looked up once, through the runtime.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) == cudaSuccess
               ? reinterpret_cast<EncodeTiled>(fn)
               : nullptr;
  }();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode == nullptr ||
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int kSub, bool kHalo, int kN, bool kBwd>
cudaError_t launch_mdcl(const Mdcl& p, int batch, cudaStream_t s) {
  const int tiles = (p.patches + kSub - 1) / kSub * ((p.channels + kN - 1) / kN);
  const int bytes = smem_bytes(kSub, kHalo, p.radius, kN);
  const cuuint64_t c = p.channels, rows = 9ull * p.branches.n * p.channels;
  CUtensorMap taps_map{}, act_map{};
  cudaError_t err;
  if constexpr (kBwd) {
    // taps (T, C in, C out) read as K-major B: (8 outputs, C inputs, T taps, C / 8 output groups); rows past C are zeros
    const cuuint64_t taps_dims[4] = {8, c, 9ull * p.branches.n, c / 8};
    const cuuint64_t taps_strides[3] = {2 * c, 2 * c * c, 16};
    const cuuint32_t taps_box[4] = {8, static_cast<cuuint32_t>(kN), 1, 8};
    err = tensor_map(&taps_map, p.taps, 4, taps_dims, taps_strides, taps_box);
  } else {
    // taps (T * C rows of C): (8 outputs, 8 inputs, C / 8 output runs, T * C / 8 input groups)
    const cuuint64_t taps_dims[4] = {8, 8, c / 8, rows / 8};
    const cuuint64_t taps_strides[3] = {2 * c, 16, 16 * c};
    const cuuint32_t taps_box[4] = {8, 8, kN / 8, 8};
    err = tensor_map(&taps_map, p.taps, 4, taps_dims, taps_strides, taps_box);
  }
  if (err == cudaSuccess && kHalo) {
    // the pixel-major input: (8 channels, width, height, C / 8 groups, batch; twice that for the pairs)
    const cuuint64_t w = p.width, h = p.height;
    const cuuint64_t act_dims[5] = {8, w, h, c / 8, static_cast<cuuint64_t>(batch) * (kBwd ? 2 : 1)};
    const cuuint64_t act_strides[4] = {2 * c, 2 * c * w, 16, 2 * c * w * h};
    const cuuint32_t side = kTileP / 8 + 2 * p.radius;
    const cuuint32_t act_box[5] = {8, side, side, kGroups, 1};
    err = tensor_map(&act_map, p.in, 5, act_dims, act_strides, act_box);
  }
  if constexpr (kBwd) {
    if (err == cudaSuccess) err = npe::allow_dynamic_smem<mdcl_bwd_kernel<kSub, kHalo, kN>>(bytes);
    if (err != cudaSuccess) return err;
    mdcl_bwd_kernel<kSub, kHalo, kN><<<dim3(tiles, p.splits), 128 * kSub, bytes, s>>>(p, taps_map, act_map);
  } else {
    if (err == cudaSuccess) err = npe::allow_dynamic_smem<mdcl_kernel<kSub, kHalo, kN>>(bytes);
    if (err != cudaSuccess) return err;
    mdcl_kernel<kSub, kHalo, kN><<<dim3(tiles, p.splits), 128 * kSub, bytes, s>>>(p, taps_map, act_map);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int quads = p.channels * p.height * p.width / 4;
  if constexpr (kBwd)
    add_slices_bwd_kernel<<<dim3((quads + kThreads - 1) / kThreads, batch), kThreads, 0, s>>>(p);
  else
    add_slices_kernel<<<dim3((quads + kThreads - 1) / kThreads, batch), kThreads, 0, s>>>(
        p.partial, p.aff_out, p.resid, p.out, p.splits, p.channels, p.height * p.width, p.pixel_major);
  return cudaGetLastError();
}

// The kernel for a plan: 256-channel tiles only with two patches a block.
template <bool kBwd>
cudaError_t mdcl(Mdcl p, int batch, int sub, bool halo, int tile_n, cudaStream_t s) {
  if (sub == 2 && tile_n == 256)
    return halo ? launch_mdcl<2, true, 256, kBwd>(p, batch, s) : launch_mdcl<2, false, 256, kBwd>(p, batch, s);
  if (sub == 2)
    return halo ? launch_mdcl<2, true, 128, kBwd>(p, batch, s) : launch_mdcl<2, false, 128, kBwd>(p, batch, s);
  return halo ? launch_mdcl<1, true, 128, kBwd>(p, batch, s) : launch_mdcl<1, false, 128, kBwd>(p, batch, s);
}

// The checks and the fields both directions share (parts: 1 forward, 2
// backward); false if the arguments are not a plan's.
bool plan_mdcl(Mdcl& p, int parts, int batch, int channels, int height, int width, int n_branches,
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
  p.units = (channels + kKc - 1) / kKc * parts * 9 * n_branches;
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
  if (!plan_mdcl(p, 1, batch, channels, height, width, n_branches, dilations, sub_tiles, halo, tile_channels,
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
  err = mdcl<false>(p, batch, sub_tiles, halo != 0, tile_channels, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  p.in = static_cast<const bf16*>(h1);
  p.taps = static_cast<const bf16*>(taps2);
  p.out = static_cast<bf16*>(out);
  p.aff_out = af + 4 * channels;
  p.resid = xb;
  p.pixel_major = 0;
  return static_cast<int>(mdcl<false>(p, batch, sub_tiles, halo != 0, tile_channels, s));
}

// The input gradient of npe_mdblock_bf16 (the header). g (y's cotangent), x,
// y, dx: (batch, channels, height, width) bf16 NCHW; h1: the forward's h1
// scratch (pixel-major bf16); gr, gm1: scratch bf16 of twice x's size (the
// (hi, lo) pairs of g_r and g_m1, pixel-major, the lo images after the hi);
// taps1, taps2, aff, partial, dilations and the plan (sub_tiles, halo,
// tile_channels, splits) as for npe_mdblock_bf16, whose plan for the shape
// this takes. Three to five launches on `stream`; returns the first CUDA
// error code (0 = all launched).
extern "C" int npe_mdblock_bwd_bf16(const void* g, const void* x, const void* y, const void* h1, const void* taps1,
                                    const void* taps2, const void* aff, void* gr, void* gm1, void* partial, void* dx,
                                    int batch, int channels, int height, int width, int n_branches,
                                    const int* dilations, int sub_tiles, int halo, int tile_channels, int splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = height * width;
  Mdcl p;
  if (!plan_mdcl(p, 2, batch, channels, height, width, n_branches, dilations, sub_tiles, halo, tile_channels,
                 splits, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(aff);
  bwd_prologue_bf16_kernel<<<dim3(hw / kTileP, (channels + kKc - 1) / kKc, batch), kThreads, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(y), af + 4 * channels, static_cast<bf16*>(gr), channels,
      hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  p.aff_out = af;
  p.grad = static_cast<const bf16*>(g);
  p.y = static_cast<const bf16*>(y);
  p.in = static_cast<const bf16*>(gr);
  p.taps = static_cast<const bf16*>(taps2);
  p.out = static_cast<bf16*>(gm1);
  p.mask = static_cast<const bf16*>(h1);
  p.pixel_major = 1;
  err = mdcl<true>(p, batch, sub_tiles, halo != 0, tile_channels, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  p.in = static_cast<const bf16*>(gm1);
  p.taps = static_cast<const bf16*>(taps1);
  p.out = static_cast<bf16*>(dx);
  p.mask = static_cast<const bf16*>(x);
  p.pixel_major = 0;
  return static_cast<int>(mdcl<true>(p, batch, sub_tiles, halo != 0, tile_channels, s));
}
