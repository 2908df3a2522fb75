// A wgmma version of the MDBLOCK kernel (npe_tpu_torch/csrc/mdblock.cu),
// kept beside the package as a measured alternative and not used by it:
// `python3 scripts/kernel_ab.py --wgmma` builds it and times it against the
// shipped kernel in turns.
//
// The same function, C entry point, 3xTF32 split and per-step float32
// running sums as mdblock.cu, whose header explains them. What differs: a
// block of two warpgroups computes a tile of 128 pixels, counted over the
// whole batch, by 128 output channels with wgmma.mma_async m64n128k8 TF32,
// each warpgroup 64 pixel rows of it. Both operands are staged through
// registers (the prologue, the zero border, the hi / lo split) into two
// shared-memory stages as K-major slabs without swizzle, the NCHW
// activations transposed on the way in: 64 KB a block, one block a
// multiprocessor. Its slice rule: the largest divisor of the inner dimension
// that keeps all blocks in one wave of one a multiprocessor.
//
// Measured (PERF.md): faster than mdblock.cu at batch 128 at all three of
// full IAN's shapes, and at one image at 16x16x256 and 32x32x128, but slower
// at one image at 8x8x512, where its 128-pixel tile is half empty; per
// decode at one image, the editor's shape, it loses, which is why the
// package ships mdblock.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "../npe_tpu_torch/csrc/dynamic_smem.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups, 64 pixels each
constexpr int kBlocksPerSm = 1;
constexpr int kTileP = 128;    // pixels of a tile, counted over the batch
constexpr int kTileC = 128;    // output channels of a tile (wgmma's N)
constexpr int kStep = 16;      // input channels of one stage: two k8 slabs
// One k8 slab of an operand, K-major without swizzle: core matrices of
// 8 rows x 16 bytes (4 TF32), 128 bytes each; the two along K 128 bytes
// apart (LBO), the 8-row groups 256 bytes apart (SBO).
constexpr int kLbo = 128, kSbo = 256;
constexpr int kSlabFloats = 128 * 8;  // 128 rows x 8 k (both operands have 128 rows)
constexpr int kSmemBytes = 2 * 2 * 2 * 2 * kSlabFloats * 4;  // (A, B) x stage x (hi, lo) x slab
constexpr int kMaxBranches = 8;

struct Branches {
  int n;
  int dilation[kMaxBranches];
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

__device__ __forceinline__ float4 epilogue(float4 v, const float* resid, float s, float t) {
  if (resid != nullptr) {
    const float4 r = *reinterpret_cast<const float4*>(resid);
    v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
  }
  return make_float4(lrelu(fmaf(s, v.x, t)), lrelu(fmaf(s, v.y, t)), lrelu(fmaf(s, v.z, t)),
                     lrelu(fmaf(s, v.w, t)));
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// Float offset of element (row, k) in a K-major slab.
__device__ __forceinline__ int slab_offset(int row, int k) {
  return ((row / 8) * kSbo + (k / 4) * kLbo + (row % 8) * 16 + (k % 4) * 4) / 4;
}

__device__ __forceinline__ uint64_t slab_desc(const float* slab) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(slab));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d (+)= A * B over one k8 slab each: A 64 x 8, B 8 x 128, both K-major in
// shared memory; scale_d 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_tf32(float d[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mdcl_kernel(const float* __restrict__ in, const float* __restrict__ aff_in,
            const float* __restrict__ taps, Branches branches, float* __restrict__ dst,
            const float* __restrict__ aff_out, const float* __restrict__ resid, int batch, int channels,
            int height, int width, int units_per_split) {
  // (stage, hi / lo, k8 slab): the activations (pixel rows), then the taps
  // (output channel rows)
  extern __shared__ __align__(128) float smem[];
  float (*as)[2][2][kSlabFloats] = reinterpret_cast<float (*)[2][2][kSlabFloats]>(smem);
  float (*ws)[2][2][kSlabFloats] = reinterpret_cast<float (*)[2][2][kSlabFloats]>(smem + 2 * 2 * 2 * kSlabFloats);
  const int hw = height * width;
  const int tiles_c = (channels + kTileC - 1) / kTileC;
  const int tile_c = blockIdx.x % tiles_c, tile_p = blockIdx.x / tiles_c;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, tig = lane % 4;
  // What this thread stages: pixel / output channel `row` of the tile, input
  // channels 4 kq .. 4 kq + 3 and 4 kq + 8 .. 4 kq + 11 of the step.
  const int row = tid % 128, kq = tid / 128;
  const int pix = tile_p * kTileP + row;  // over the whole batch
  const bool pix_ok = pix < batch * hw;
  const int n = pix / hw, p = pix % hw;
  const int py = p / width, px = p % width;
  const int co = tile_c * kTileC + row;
  const bool co_ok = co < channels;
  const int units_per_tap = channels / kStep;

  float acc[64], step[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = step[e] = 0.0f;
  float a_next[8], w_next[8];
  bool inside_next = false;
  int c_next = 0;

  auto fetch = [&](int unit) {
    const int t = unit / units_per_tap;
    const int c0 = kStep * (unit - t * units_per_tap);
    const int dil = branches.dilation[t / 9];
    const int y = py + (t % 9 / 3 - 1) * dil, x = px + (t % 3 - 1) * dil;
    inside_next = pix_ok && y >= 0 && y < height && x >= 0 && x < width;
    c_next = c0 + 4 * kq;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c_next + e % 4 + 8 * (e / 4);
      a_next[e] = inside_next ? __ldg(in + (static_cast<size_t>(n) * channels + c) * hw + y * width + x) : 0.0f;
      w_next[e] = co_ok ? __ldg(taps + (static_cast<size_t>(t) * channels + c) * channels + co) : 0.0f;
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k 4kq .. 4kq+3 of slab h
      uint32_t ahi[4], alo[4], whi[4], wlo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = a_next[4 * h + q];
        if (aff_in != nullptr && inside_next) {
          const int c = c_next + q + 8 * h;
          v = lrelu(fmaf(__ldg(aff_in + c), v, __ldg(aff_in + channels + c)));
        }
        split_tf32(v, ahi[q], alo[q]);
        split_tf32(w_next[4 * h + q], whi[q], wlo[q]);
      }
      const int off = slab_offset(row, 4 * kq);
      *reinterpret_cast<uint4*>(&as[s][0][h][off]) = make_uint4(ahi[0], ahi[1], ahi[2], ahi[3]);
      *reinterpret_cast<uint4*>(&as[s][1][h][off]) = make_uint4(alo[0], alo[1], alo[2], alo[3]);
      *reinterpret_cast<uint4*>(&ws[s][0][h][off]) = make_uint4(whi[0], whi[1], whi[2], whi[3]);
      *reinterpret_cast<uint4*>(&ws[s][1][h][off]) = make_uint4(wlo[0], wlo[1], wlo[2], wlo[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  const int wg_rows = 64 * (warp / 4);  // this warpgroup's pixel rows of the tile
  const int first = split * units_per_split, last = first + units_per_split;
  fetch(first);
  store(0);
  __syncthreads();
  for (int unit = first; unit < last; ++unit) {
    const int s = (unit - first) & 1;
    const bool more = unit + 1 < last;
    if (more) fetch(unit + 1);
#pragma unroll
    for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(step[e])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a_off = slab_offset(wg_rows, 0);
      const uint64_t a_hi = slab_desc(&as[s][0][h][a_off]), a_lo = slab_desc(&as[s][1][h][a_off]);
      const uint64_t b_hi = slab_desc(ws[s][0][h]), b_lo = slab_desc(ws[s][1][h]);
      wgmma_tf32(step, a_lo, b_hi, h);  // the first product of a step starts from zero
      wgmma_tf32(step, a_hi, b_lo, 1);
      wgmma_tf32(step, a_hi, b_hi, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (more) store(s ^ 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(step[e])::"memory");
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += step[e];
    __syncthreads();
  }

  // Element e of the accumulator is pixel wg_rows + 16 (warp % 4) + grp
  // (+ 8 for e % 4 >= 2) and channel 8 (e / 4) + 2 tig (+ 1 for odd e).
#pragma unroll
  for (int lower = 0; lower < 2; ++lower) {
    const int P = tile_p * kTileP + wg_rows + 16 * (warp % 4) + grp + 8 * lower;
    if (P >= batch * hw) continue;
    const int n_img = P / hw, pp = P % hw;
    const size_t image = aff_out == nullptr ? static_cast<size_t>(n_img) * gridDim.y + split : n_img;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int e = 4 * (q / 2) + 2 * lower + (q & 1);
      const int c = tile_c * kTileC + 8 * (e / 4) + 2 * tig + (e & 1);
      if (c >= channels) continue;
      const size_t at = (image * channels + c) * hw + pp;
      float v = acc[e];
      if (aff_out != nullptr) {
        if (resid != nullptr) v += resid[at];
        v = lrelu(fmaf(__ldg(aff_out + c), v, __ldg(aff_out + channels + c)));
      }
      dst[at] = v;
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
  const dim3 grid(((batch * hw + kTileP - 1) / kTileP) * ((channels + kTileC - 1) / kTileC), splits);
  const int units_per_split = 9 * branches.n * (channels / kStep) / splits;
  cudaError_t err = npe::allow_dynamic_smem<mdcl_kernel>(kSmemBytes);
  if (err != cudaSuccess) return err;
  if (splits == 1) {
    mdcl_kernel<<<grid, kThreads, kSmemBytes, s>>>(in, aff_in, taps, branches, out, aff_out, resid, batch,
                                                   channels, height, width, units_per_split);
    return cudaGetLastError();
  }
  mdcl_kernel<<<grid, kThreads, kSmemBytes, s>>>(in, aff_in, taps, branches, partial, nullptr, nullptr, batch,
                                                 channels, height, width, units_per_split);
  err = cudaGetLastError();
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
  cudaError_t err = mdcl(xf, af, static_cast<const float*>(taps1), branches, static_cast<float*>(partial),
                         static_cast<float*>(h1), af + 2 * channels, nullptr, batch, channels, height, width,
                         splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = mdcl(static_cast<const float*>(h1), nullptr, static_cast<const float*>(taps2), branches,
             static_cast<float*>(partial), static_cast<float*>(out), af + 4 * channels, xf, batch,
             channels, height, width, splits, s);
  return static_cast<int>(err);
}
