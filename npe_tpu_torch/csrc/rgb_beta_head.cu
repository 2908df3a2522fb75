// rgb_beta_head: the whole RGB-Beta head, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// npe_tpu/ops/pallas/mdcl_kernels.py:rgb_beta_head_pallas (body
// `_beta_head_kernel`): the trunk MDCLs R / G_a / B_a over the decoder's last
// feature map, then the autoregressive tail of rgb_beta_tail.cuh; and x's
// gradient of its custom VJP (`_head_bwd`): the tail's backward passes, then
// `head_trunk_bwd_kernel` (its design is in the comment above it). The TPU
// kernel computes the trunk as nine tap products over the space-to-depth(4)
// map, which suits a 128-lane MXU; here it is the MDCL as it is, a direct
// multiscale conv over the NCHW map:
//
//   trunk6[co, y, x] = sum_t sum_c taps[t, c, co] * x[c, y + dy_t, x + dx_t]
//
// over the taps of `tap_offsets(scales)` (nine per dilation 1, 2, 3, 4 at
// scales 2/3/4; npe_tpu_torch/ops/kernels/mdblock.py), zero outside the map.
// The centre appears once per dilation; the kernel folds those taps into one,
// so an output reads 33 distinct offsets, not 36.
//
// Bound: operations. At C = 64 and one 64x64 image the trunk is 4096 pixels x
// 6 outputs x 64 channels x 33 offsets = 51.9 M multiply-adds, the tail's
// G_b and B_b MDCLs (2 -> 2 and 4 -> 2 over the same 33 offsets) 1.6 M: about
// 107 MFLOP, 1.6 us at 67 TFLOP/s of float32, against 1.15 MB moved (x 1.0 MB,
// the taps and the image), 0.34 us at 3.35 TB/s. The s2d form this replaces
// did 4.4 times the trunk's work (9 x 1024 x 96 per cell, the structural
// zeros of the composed 9x9 kernel included) and read a 3.5 MB tap tensor.
// TF32 and the tensor cores are not used: the port's parity is float32, and
// 6 outputs would fill three quarters of an mma tile 8 wide.
//
// Design. The trunk launch cuts the work into independent blocks three ways:
// bands of four pixel rows (one cell row of the tail's s2d layout), slices of
// the input channels, and the batch; the wrapper picks the slice count
// (`head_slices`: 8 slices of 8 channels at C = 64 and one image, 16 x 8 =
// 128 blocks; fewer as the batch grows; scripts/kernel_sweep.py has the times
// behind it). A block copies its band plus a halo of four rows (zero outside
// the map) for eight channels at a time into shared memory, as 16-byte
// cp.async copies of the NCHW rows, with the taps of those channels, every
// copy in flight at once, then folds the centres. Its 256 threads are four
// groups of 64; a thread owns one column of the band (4 pixels x 6 outputs
// in registers) and takes two of its group's channels at a time, so a warp
// reads 32 neighbouring words per product and one broadcast tap row. The
// four groups' sums are added in order through shared memory and written in
// the tail's s2d layout (n, 96, hh, 16); with more than one slice into a
// scratch of partial sums (0.79 MB at batch 1), which a second launch adds
// over the card in slice order. A fixed order and no atomics, so the result
// does not change from run to run. (A thread block cluster per band, adding
// its slices through distributed shared memory, was tried and measured
// slower: a cluster of eight blocks two to an SM leaves SMs idle at batch
// 1, and one to an SM does not fit 16 clusters at once; PERF.md.) The last
// launch is the tail kernel of rgb_beta_tail.cuh as it stands. Left for a
// later change: double-buffered chunks (a block has one at batch 1), more
// pixels a thread (fewer shared-memory reads per product), and a
// programmatic dependent launch of the second pass.
//
// bfloat16. Given bf16 x and taps, npe_tpu's kernel takes bf16 operands and
// keeps the trunk in float32 (`_beta_head_kernel`: the products'
// preferred_element_type), then runs the tail in bf16. The bf16 form here is
// the same trunk kernel over a template: x and the taps are widened to
// float32 as they are staged (exact; ordinary 16-byte loads where the float32
// form has cp.async), the products and sums are float32, and the trunk and
// the slices' partial sums stay float32; the tail is rgb_beta_tail.cuh's bf16
// form over that float32 trunk, and the image is bf16.

#include "rgb_beta_tail.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;        // of 64 threads, one column of the band each
constexpr int kWidth = 64;        // pixels a row: the tail's 16 cells
constexpr int kBand = 4;          // pixel rows a block: one cell row
constexpr int kHaloPx = 4;        // the largest dilation
constexpr int kRows = kBand + 2 * kHaloPx;
constexpr int kStride = 80;       // a staged row: 4 zeros, 64 pixels, 4 zeros, 8 spare (bank offset 16)
constexpr int kChunk = 8;         // channels staged at a time
constexpr int kMaxDil = 4;        // dilations (branches) at most
constexpr int kMaxTaps = 9 * kMaxDil;
constexpr int kCo = 6;            // R alpha, R beta, G_a alpha, G_a beta, B_a alpha, B_a beta
constexpr int kTapStride = 8;     // a tap's six outputs, padded for one float4 and one float2 read
constexpr int kOut = kCo * kBand * kWidth;  // 1536 outputs a band
constexpr int kMaxSlices = 8;
constexpr int kAddThreads = 256;

struct Dilations {
  int d[kMaxDil];
};

// 16 bytes from global to shared memory, or 16 zero bytes where !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// acc[r][o] += the products of the staged channels cl, cl + kGroups, ...
// (kCh of them) at this thread's column over every tap, tap by tap.
template <int kCh>
__device__ __forceinline__ void tap_products(const float* xs, const float* ws, int cl, int col, int n_dil,
                                             const Dilations& dil, float (&acc)[kBand][kCo]) {
#pragma unroll
  for (int b = 0; b < kMaxDil; ++b) {
    if (b < n_dil) {
      const int d = dil.d[b];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int i = tap / 3 - 1, j = tap % 3 - 1;
        if (b > 0 && i == 0 && j == 0) continue;  // folded into the first centre
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) {
          const int c = cl + ch * kGroups;
          const float* wt = ws + (c * kMaxTaps + 9 * b + tap) * kTapStride;
          const float4 wa = *reinterpret_cast<const float4*>(wt);
          const float2 wb = *reinterpret_cast<const float2*>(wt + 4);
          const float wv[kCo] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y};
          const float* xp = xs + (c * kRows + kHaloPx) * kStride + kHaloPx + col + d * (i * kStride + j);
#pragma unroll
          for (int r = 0; r < kBand; ++r) {
            const float v = xp[r * kStride];
#pragma unroll
            for (int o = 0; o < kCo; ++o) acc[r][o] = fmaf(v, wv[o], acc[r][o]);
          }
        }
      }
    }
  }
}

// taps: (T, channels, 6), T = 9 * n_dil, in the order of `tap_offsets`;
// sums: the trunk (batch, 96, hh, 16), the tail's component-major s2d
// layout, or with more than one slice the partial sums (batch, slices, 96,
// hh, 16), float32 in both forms. T is float or __nv_bfloat16 (x and taps).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
head_trunk_kernel(const T* __restrict__ x, const T* __restrict__ taps, float* __restrict__ sums,
                  int channels, int hh, int n_dil, Dilations dil) {
  __shared__ __align__(16) float xs[kChunk * kRows * kStride];
  __shared__ __align__(16) float ws[kChunk * kMaxTaps * kTapStride];
  const int band = blockIdx.x, slice = blockIdx.y, slices = gridDim.y, n = blockIdx.z;
  const int height = kBand * hh, n_taps = 9 * n_dil;
  const int c_begin = slice * channels / slices, c_end = (slice + 1) * channels / slices;
  const int tid = threadIdx.x, group = tid / kWidth, col = tid % kWidth;

  for (int i = tid; i < kChunk * kRows * 2 * kHaloPx; i += kThreads) {  // the zero columns either side
    const int side = i % (2 * kHaloPx);
    xs[(i / (2 * kHaloPx)) * kStride + (side < kHaloPx ? side : kWidth + side)] = 0.0f;
  }

  float acc[kBand][kCo];
#pragma unroll
  for (int r = 0; r < kBand; ++r)
#pragma unroll
    for (int o = 0; o < kCo; ++o) acc[r][o] = 0.0f;

  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    const int kc = min(kChunk, c_end - c0);
    __syncthreads();  // the zeroing, or the last chunk's reads, are done
    // the band and its halo, kc channels, as 16-byte rows (zero outside the
    // map), and their taps: every copy in flight at once
    if constexpr (std::is_same_v<T, float>) {
      for (int i = tid; i < kc * kRows * (kWidth / 4); i += kThreads) {
        const int cl = i / (kRows * (kWidth / 4)), row = (i / (kWidth / 4)) % kRows, q = i % (kWidth / 4);
        const int y = band * kBand - kHaloPx + row;
        const bool inside = y >= 0 && y < height;
        cp_async16(&xs[(cl * kRows + row) * kStride + kHaloPx + 4 * q],
                   inside ? x + ((static_cast<size_t>(n) * channels + c0 + cl) * height + y) * kWidth + 4 * q : x,
                   inside);
      }
      for (int i = tid; i < kc * n_taps * kCo; i += kThreads) {
        const int o = i % kCo, cl = (i / kCo) % kc, t = i / (kCo * kc);  // a tap's rows are contiguous
        cp_async4(&ws[(cl * kMaxTaps + t) * kTapStride + o],
                  taps + (static_cast<size_t>(t) * channels + c0 + cl) * kCo + o);
      }
    } else {  // bf16: eight pixels (16 bytes) a load, widened into the same float32 rows
      for (int i = tid; i < kc * kRows * (kWidth / 8); i += kThreads) {
        const int cl = i / (kRows * (kWidth / 8)), row = (i / (kWidth / 8)) % kRows, q = i % (kWidth / 8);
        const int y = band * kBand - kHaloPx + row;
        float v[8] = {};
        if (y >= 0 && y < height)
          npe::bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(
                                 x + ((static_cast<size_t>(n) * channels + c0 + cl) * height + y) * kWidth) + q), v);
        float4* dst = reinterpret_cast<float4*>(&xs[(cl * kRows + row) * kStride + kHaloPx + 8 * q]);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      for (int i = tid; i < kc * n_taps * kCo; i += kThreads) {
        const int o = i % kCo, cl = (i / kCo) % kc, t = i / (kCo * kc);
        ws[(cl * kMaxTaps + t) * kTapStride + o] = npe::to_f32(taps[(static_cast<size_t>(t) * channels + c0 + cl) * kCo + o]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (n_dil > 1) {  // every branch's centre folded into the first branch's, in branch order
      for (int i = tid; i < kc * kCo; i += kThreads) {
        float* w = ws + (i / kCo) * kMaxTaps * kTapStride + i % kCo;
        float v = w[4 * kTapStride];
        for (int b = 1; b < n_dil; ++b) v += w[(9 * b + 4) * kTapStride];
        w[4 * kTapStride] = v;
      }
      __syncthreads();
    }

    // this group's channels of the chunk, two at a time (twice the
    // independent products between shared-memory reads)
    int cl = group;
    for (; cl + kGroups < kc; cl += 2 * kGroups) tap_products<2>(xs, ws, cl, col, n_dil, dil, acc);
    if (cl < kc) tap_products<1>(xs, ws, cl, col, n_dil, dil, acc);
  }
  __syncthreads();

  // the four groups' sums, added in order, written in the tail's s2d layout:
  // plane o * 16 + 4 * r + q of cell row `band` holds pixel (r, 4 * j + q)
  float* red = xs;  // group g's output o at pixel p: red[g * kOut + o * 256 + p]
#pragma unroll
  for (int r = 0; r < kBand; ++r)
#pragma unroll
    for (int o = 0; o < kCo; ++o) red[(group * kCo + o) * kBand * kWidth + r * kWidth + col] = acc[r][o];
  __syncthreads();
  float* dst = sums + static_cast<size_t>(n * slices + slice) * kCo * npe::kRR * hh * (kWidth / 4);
  for (int e = tid; e < kOut; e += kThreads) {
    const int j = e % (kWidth / 4), plane = e / (kWidth / 4);
    const int o = plane / npe::kRR, r = (plane % npe::kRR) / 4, q = plane % 4;
    const int src = o * kBand * kWidth + r * kWidth + 4 * j + q;
    float v = red[src];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) v += red[g * kOut + src];
    dst[(static_cast<size_t>(plane) * hh + band) * (kWidth / 4) + j] = v;
  }
}

// trunk[n, i] = sum over the slices s, in order, of partial[n, s, i].
__global__ void __launch_bounds__(kAddThreads)
add_slices_kernel(const float* __restrict__ partial, float* __restrict__ trunk, int slices, int per_image) {
  const int i = blockIdx.x * kAddThreads + threadIdx.x;
  if (i >= per_image) return;
  const float* p = partial + static_cast<size_t>(blockIdx.y) * slices * per_image + i;
  float s = p[0];
  for (int k = 1; k < slices; ++k) s += p[static_cast<size_t>(k) * per_image];
  trunk[static_cast<size_t>(blockIdx.y) * per_image + i] = s;
}

template <typename T>
int head_trunk(const void* x, const void* taps, void* trunk, void* partial, int batch, int channels, int hh,
               int n_dil, const int* dil, int slices, void* stream) {
  if (n_dil < 1 || n_dil > kMaxDil || slices < 1 || slices > kMaxSlices || slices > channels)
    return static_cast<int>(cudaErrorInvalidValue);
  Dilations d = {};
  for (int b = 0; b < n_dil; ++b) {
    if (dil[b] < 1 || dil[b] > kHaloPx) return static_cast<int>(cudaErrorInvalidValue);
    d.d[b] = dil[b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sums = static_cast<float*>(slices > 1 ? partial : trunk);
  head_trunk_kernel<T><<<dim3(hh, slices, batch), kThreads, 0, s>>>(static_cast<const T*>(x),
                                                                     static_cast<const T*>(taps), sums, channels,
                                                                     hh, n_dil, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const int per_image = kCo * npe::kRR * hh * (kWidth / 4);
  add_slices_kernel<<<dim3((per_image + kAddThreads - 1) / kAddThreads, batch), kAddThreads, 0, s>>>(
      sums, static_cast<float*>(trunk), slices, per_image);
  return static_cast<int>(cudaGetLastError());
}

// The trunk's backward, x's gradient (npe_tpu's `_head_bwd` for x): the
// transposed multiscale conv of dtrunk, the trunk's gradient as the tail's
// backward leaves it (float32, the tail's s2d layout, zero outside the map),
//
//   dx[c, y, x] = sum over the offsets t, k < 6, of d6[k, y - dy_t, x - dx_t] * taps[t, c, k]
//
// with d6[k, y, x] = dtrunk[k * 16 + 4 (y % 4) + x % 4, y / 4, x / 4] and the
// centres folded into one offset, as in the forward: 33 offsets at scales
// 2/3/4. Bound: operations, 198 multiply-adds an element of dx at three
// branches (51.9 M an image at C = 64, 0.0016 ms at 67 TFLOP/s, against
// 1.4 MB moved). A block is a band of four pixel rows by the 64 columns, for
// kBwdChannels channels: it stages the six planes of d6 on the band and a
// halo of four rows (unpacked from the s2d layout, zero outside the map) and
// the taps of its channels, folds the centres, and each of its 256 threads
// (four groups of 64 columns) sums one column's four pixels for two
// channels: per offset and plane four d6 reads and one float2 of taps for
// eight products. The grid is bands x channel slices x batch (128 blocks at
// C = 64 and one image). dx is rounded to x's type at the end.
constexpr int kBwdChannels = 8;  // channels a block; two a thread
constexpr int kBwdPerThread = kBwdChannels / kGroups;
static_assert(kBwdPerThread == 2, "a thread's channels are read as one float2");

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_trunk_bwd_kernel(const float* __restrict__ dtrunk, const T* __restrict__ taps, T* __restrict__ dx,
                      int channels, int hh, int n_dil, Dilations dil) {
  __shared__ __align__(16) float ds[kCo * kRows * kStride];
  __shared__ __align__(16) float ws[kMaxTaps * kCo * kBwdChannels];  // (tap, k, channel of the block)
  const int band = blockIdx.x, c0 = blockIdx.y * kBwdChannels, n = blockIdx.z;
  const int height = kBand * hh, n_taps = 9 * n_dil, cells = hh * (kWidth / 4);
  const int tid = threadIdx.x, group = tid / kWidth, col = tid % kWidth;
  const float* dt = dtrunk + static_cast<size_t>(n) * kCo * npe::kRR * cells;

  for (int i = tid; i < kCo * kRows * kStride; i += kThreads) ds[i] = 0.0f;
  for (int i = tid; i < n_taps * kCo * kBwdChannels; i += kThreads) {
    const int cl = i % kBwdChannels, k = (i / kBwdChannels) % kCo, t = i / (kBwdChannels * kCo);
    ws[i] = c0 + cl < channels ? npe::to_f32(taps[(static_cast<size_t>(t) * channels + c0 + cl) * kCo + k]) : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kCo * kRows * kWidth; i += kThreads) {
    const int x = i % kWidth, row = (i / kWidth) % kRows, k = i / (kWidth * kRows);
    const int y = band * kBand - kHaloPx + row;
    if (y >= 0 && y < height)
      ds[(k * kRows + row) * kStride + kHaloPx + x] =
          dt[(static_cast<size_t>(k * npe::kRR + 4 * (y % 4) + x % 4) * hh + y / 4) * (kWidth / 4) + x / 4];
  }
  if (n_dil > 1) {  // every branch's centre folded into the first branch's, in branch order
    __syncthreads();
    for (int i = tid; i < kCo * kBwdChannels; i += kThreads) {
      float* w = ws + 4 * kCo * kBwdChannels + i;
      float v = *w;
      for (int b = 1; b < n_dil; ++b) v += w[9 * b * kCo * kBwdChannels];
      *w = v;
    }
  }
  __syncthreads();

  float acc[kBand][kBwdPerThread];
#pragma unroll
  for (int r = 0; r < kBand; ++r)
#pragma unroll
    for (int q = 0; q < kBwdPerThread; ++q) acc[r][q] = 0.0f;
  for (int b = 0; b < n_dil; ++b) {
    const int d = dil.d[b];
    for (int tap = 0; tap < 9; ++tap) {
      const int i = tap / 3 - 1, j = tap % 3 - 1;
      if (b > 0 && i == 0 && j == 0) continue;  // folded into the first centre
      const float* xp = ds + (kHaloPx - d * i) * kStride + kHaloPx + col - d * j;
      const float* wt = ws + (9 * b + tap) * kCo * kBwdChannels + kBwdPerThread * group;
#pragma unroll
      for (int k = 0; k < kCo; ++k) {
        const float2 w = *reinterpret_cast<const float2*>(wt + k * kBwdChannels);
#pragma unroll
        for (int r = 0; r < kBand; ++r) {
          const float v = xp[(k * kRows + r) * kStride];
          acc[r][0] = fmaf(v, w.x, acc[r][0]);
          acc[r][1] = fmaf(v, w.y, acc[r][1]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kBwdPerThread; ++q) {
    const int c = c0 + kBwdPerThread * group + q;
    if (c >= channels) continue;
#pragma unroll
    for (int r = 0; r < kBand; ++r)
      dx[((static_cast<size_t>(n) * channels + c) * height + band * kBand + r) * kWidth + col] =
          npe::from_f32<T>(acc[r][q]);
  }
}

// x's gradient: the tail's backward (its passes for the trunk alone, reading
// the image's cotangent g) into dtrunk, then the trunk's backward into dx.
template <typename T>
int head_bwd(const void* g, const void* trunk, const void* taps, const void* tg, const void* tb, void* scratch,
             void* dtrunk, void* dx, int batch, int channels, int hh, int n_dil, const int* dil, int tail_rows,
             void* stream) {
  if (n_dil < 1 || n_dil > kMaxDil) return static_cast<int>(cudaErrorInvalidValue);
  Dilations d = {};
  for (int b = 0; b < n_dil; ++b) {
    if (dil[b] < 1 || dil[b] > kHaloPx) return static_cast<int>(cudaErrorInvalidValue);
    d.d[b] = dil[b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const npe::TailBwdArgs<float, T> a{static_cast<const T*>(g), static_cast<const float*>(trunk),
                                     static_cast<const T*>(tg), static_cast<const T*>(tb),
                                     static_cast<float*>(scratch), static_cast<float*>(dtrunk), nullptr, nullptr,
                                     nullptr, hh, kWidth / 4, tail_rows};
  const int err = npe::launch_tail_bwd<true>(a, batch, 1, 0, s);
  if (err != 0) return err;
  head_trunk_bwd_kernel<T><<<dim3(hh, (channels + kBwdChannels - 1) / kBwdChannels, batch), kThreads, 0, s>>>(
      static_cast<const float*>(dtrunk), static_cast<const T*>(taps), static_cast<T*>(dx), channels, hh, n_dil, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int head(const void* x, const void* taps, const void* tg, const void* tb, void* trunk, void* partial, void* out,
         int batch, int channels, int hh, int n_dil, const int* dil, int slices, int tail_rows, void* stream) {
  const int err = head_trunk<T>(x, taps, trunk, partial, batch, channels, hh, n_dil, dil, slices, stream);
  if (err != 0) return err;
  return npe::launch_tail<true>(static_cast<const float*>(trunk), static_cast<const T*>(tg),
                                static_cast<const T*>(tb), static_cast<T*>(out), batch, hh, kWidth / 4,
                                tail_rows, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The trunk alone. x: (batch, channels, 4*hh, 64) float32 NCHW; taps:
// (9*n_dil, channels, 6) in the order of `tap_offsets`; dil: n_dil
// dilations, each at most 4 (1 <= n_dil <= 4); trunk: (batch, 96, hh, 16);
// slices: 1 to 8, at most channels; partial: scratch (batch, slices, 96, hh,
// 16), unused (may be null) when slices is 1. All contiguous and 16-byte
// aligned. One launch, or two with slices; returns the first CUDA error code.
extern "C" int npe_rgb_beta_head_trunk(const void* x, const void* taps, void* trunk, void* partial, int batch,
                                       int channels, int hh, int n_dil, const int* dil, int slices, void* stream) {
  return head_trunk<float>(x, taps, trunk, partial, batch, channels, hh, n_dil, dil, slices, stream);
}

// The whole head: the trunk, then the tail's launch. x, taps, dil, slices,
// partial as for npe_rgb_beta_head_trunk; tg: (9, 32, 32); tb: (9, 64, 32);
// trunk: scratch (batch, 96, hh, 16); out: (batch, 3, 4*hh, 64); tail_rows:
// the tail's cell rows a block (a divisor of hh, which is even). Returns the
// first CUDA error code (0 = all launched).
extern "C" int npe_rgb_beta_head(const void* x, const void* taps, const void* tg, const void* tb, void* trunk,
                                 void* partial, void* out, int batch, int channels, int hh, int n_dil,
                                 const int* dil, int slices, int tail_rows, void* stream) {
  return head<float>(x, taps, tg, tb, trunk, partial, out, batch, channels, hh, n_dil, dil, slices, tail_rows,
                     stream);
}

// The bfloat16 forms of the two: x, taps, tg, tb and out bf16; trunk and
// partial float32, as in the float32 forms.
extern "C" int npe_rgb_beta_head_trunk_bf16(const void* x, const void* taps, void* trunk, void* partial,
                                            int batch, int channels, int hh, int n_dil, const int* dil,
                                            int slices, void* stream) {
  return head_trunk<__nv_bfloat16>(x, taps, trunk, partial, batch, channels, hh, n_dil, dil, slices, stream);
}

extern "C" int npe_rgb_beta_head_bf16(const void* x, const void* taps, const void* tg, const void* tb,
                                      void* trunk, void* partial, void* out, int batch, int channels, int hh,
                                      int n_dil, const int* dil, int slices, int tail_rows, void* stream) {
  return head<__nv_bfloat16>(x, taps, tg, tb, trunk, partial, out, batch, channels, hh, n_dil, dil, slices,
                             tail_rows, stream);
}

// x's gradient of the whole head (npe_tpu's `_head_bwd` for x): g, the
// image's cotangent, (batch, 3, 4*hh, 64); trunk: the forward's float32
// (batch, 96, hh, 16); taps, tg, tb, dil as for npe_rgb_beta_head; scratch:
// (batch, 192, hh, 16) float32; dtrunk: (batch, 96, hh, 16) float32; dx:
// (batch, channels, 4*hh, 64); tail_rows as the forward's. The tail's
// backward launches (four), then the trunk's; returns the first CUDA error
// code (0 = all launched).
extern "C" int npe_rgb_beta_head_bwd(const void* g, const void* trunk, const void* taps, const void* tg,
                                     const void* tb, void* scratch, void* dtrunk, void* dx, int batch,
                                     int channels, int hh, int n_dil, const int* dil, int tail_rows, void* stream) {
  return head_bwd<float>(g, trunk, taps, tg, tb, scratch, dtrunk, dx, batch, channels, hh, n_dil, dil, tail_rows,
                         stream);
}

// The bfloat16 form: g, taps, tg, tb and dx bf16; trunk, scratch and dtrunk
// float32, as in the float32 form (the tail's bf16 form over a float32 trunk).
extern "C" int npe_rgb_beta_head_bwd_bf16(const void* g, const void* trunk, const void* taps, const void* tg,
                                          const void* tb, void* scratch, void* dtrunk, void* dx, int batch,
                                          int channels, int hh, int n_dil, const int* dil, int tail_rows,
                                          void* stream) {
  return head_bwd<__nv_bfloat16>(g, trunk, taps, tg, tb, scratch, dtrunk, dx, batch, channels, hh, n_dil, dil,
                                 tail_rows, stream);
}
