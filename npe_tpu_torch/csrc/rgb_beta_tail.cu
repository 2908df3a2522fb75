// rgb_beta_tail: the RGB-Beta head's autoregressive tail as one kernel,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// npe_tpu/ops/pallas/mdcl_kernels.py:rgb_beta_tail_pallas (body
// `_beta_tail_kernel`), and its custom VJP's backward (`_tail_bwd`). What
// they compute, what bounds them, how an image is cut over blocks and how it
// is laid out are in rgb_beta_tail.cuh, which holds the device code.

#include "rgb_beta_tail.cuh"

// trunk: (batch, 96, hh, ww) float32 component-major pre-activations; tg:
// (9, 32, 32); tb: (9, 64, 32); out: (batch, 48, hh, ww). All contiguous and
// 16-byte aligned; rows (the cell rows of a block) divides hh. Launches on
// `stream` and returns the CUDA error code.
extern "C" int npe_rgb_beta_tail(const void* trunk, const void* tg, const void* tb, void* out,
                                 int batch, int hh, int ww, int rows, void* stream) {
  return npe::launch_tail<false>(static_cast<const float*>(trunk),
                                 static_cast<const float*>(tg), static_cast<const float*>(tb),
                                 static_cast<float*>(out), batch, hh, ww, rows,
                                 static_cast<cudaStream_t>(stream));
}

// The bfloat16 form: tg, tb and out bf16, the trunk bf16 or, with trunk_f32,
// float32 (the fused head's trunk, which is never rounded). Otherwise as
// npe_rgb_beta_tail.
extern "C" int npe_rgb_beta_tail_bf16(const void* trunk, const void* tg, const void* tb, void* out,
                                      int batch, int hh, int ww, int rows, int trunk_f32, void* stream) {
  const auto* g = static_cast<const __nv_bfloat16*>(tg);
  const auto* b = static_cast<const __nv_bfloat16*>(tb);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (trunk_f32) return npe::launch_tail<false>(static_cast<const float*>(trunk), g, b, o, batch, hh, ww, rows, s);
  return npe::launch_tail<false>(static_cast<const __nv_bfloat16*>(trunk), g, b, o, batch, hh, ww, rows, s);
}

namespace {

template <typename TTrunk, typename T>
int tail_bwd(const void* g, const void* trunk, const void* tg, const void* tb, void* scratch, void* partial,
             void* dtrunk, void* dtg, void* dtb, int batch, int hh, int ww, int rows, int need_trunk, int need_taps,
             void* stream) {
  const npe::TailBwdArgs<TTrunk, T> a{static_cast<const T*>(g), static_cast<const TTrunk*>(trunk),
                                      static_cast<const T*>(tg), static_cast<const T*>(tb),
                                      static_cast<float*>(scratch), static_cast<TTrunk*>(dtrunk),
                                      static_cast<float*>(partial), static_cast<T*>(dtg), static_cast<T*>(dtb),
                                      hh, ww, rows};
  return npe::launch_tail_bwd<false>(a, batch, need_trunk, need_taps, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The backward (npe_tpu's `_tail_bwd`), rgb_beta_tail.cuh's passes: g, the
// cotangent of the output, (batch, 48, hh, ww); trunk, tg, tb as for
// npe_rgb_beta_tail; scratch: (batch, 192, hh, ww) float32; dtrunk: (batch,
// 96, hh, ww), written where need_trunk (its B and G planes always); dtg
// (9, 32, 32) and dtb (9, 64, 32), with partial (batch * hh / rows, 27648)
// float32, written where need_taps (else all three may be null). All
// contiguous and 16-byte aligned; rows as the forward's. Launches on `stream`
// and returns the first CUDA error code (0 = all launched).
extern "C" int npe_rgb_beta_tail_bwd(const void* g, const void* trunk, const void* tg, const void* tb,
                                     void* scratch, void* partial, void* dtrunk, void* dtg, void* dtb, int batch,
                                     int hh, int ww, int rows, int need_trunk, int need_taps, void* stream) {
  return tail_bwd<float, float>(g, trunk, tg, tb, scratch, partial, dtrunk, dtg, dtb, batch, hh, ww, rows,
                                need_trunk, need_taps, stream);
}

// The bfloat16 form: g, tg, tb, dtg, dtb bf16; trunk and dtrunk bf16 or, with
// trunk_f32, float32. Otherwise as npe_rgb_beta_tail_bwd.
extern "C" int npe_rgb_beta_tail_bwd_bf16(const void* g, const void* trunk, const void* tg, const void* tb,
                                          void* scratch, void* partial, void* dtrunk, void* dtg, void* dtb,
                                          int batch, int hh, int ww, int rows, int need_trunk, int need_taps,
                                          int trunk_f32, void* stream) {
  if (trunk_f32)
    return tail_bwd<float, __nv_bfloat16>(g, trunk, tg, tb, scratch, partial, dtrunk, dtg, dtb, batch, hh, ww,
                                          rows, need_trunk, need_taps, stream);
  return tail_bwd<__nv_bfloat16, __nv_bfloat16>(g, trunk, tg, tb, scratch, partial, dtrunk, dtg, dtb, batch, hh,
                                                ww, rows, need_trunk, need_taps, stream);
}
