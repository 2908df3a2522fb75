"""The inference MDBLOCK in one kernel call (reference `layers.py:411-416`):

    y = lrelu(BN2(x + MDCL2(lrelu(BN1(MDCL1(lrelu(BN0(x))))))))

with each batch norm folded to a per-channel affine and each MDCL (a base 3x3
plus one dilated 3x3 per scale over one shared filter, `layers.py:207-258`)
written as a sum over its nonzero taps of a shifted slice of the zero-padded
activation times that tap's (Cin, Cout) matrix.

Replaces the Pallas TPU kernel
`npe_tpu/ops/pallas/mdcl_kernels.py:mdblock_fused`. The source is
`npe_tpu_torch/csrc/mdblock.cu` (its header says what bounds it and how the
work is split); `mdblock_taps_reference` is the plain PyTorch version. The
kernel runs both MDCLs on the tensor cores in TF32 with three products per
multiply-add (3xTF32: each operand split into a TF32 high part and a TF32
remainder), which keeps float32 accuracy; `tf32_split` is that split in
PyTorch, for the tests that show why one product would not do.

Layout. x is NCHW as the decoder leaves it, and the kernel reads it as it
lies; no permuted copy is made. Tap matrices are (T, Cin, Cout) row-major in
the order of `tap_offsets(scales)`, from `stack_mdcl_taps`, which takes the
port's (nf, ni, 3, 3) filters. The affines are one (6, C) tensor, rows
s0, t0, s1, t1, s2, t2.

One call is two launches of one MDCL kernel (the first leaves
lrelu(BN1(MDCL1(..))) in a scratch map, the second reads it and the raw x),
each followed, when the inner dimension is cut into slices so that a single
image still spreads over the card, by a launch that adds the slices' partial
sums in a fixed order.

The bfloat16 form (x and the taps in bf16, the affines float32) is a kernel
of its own, `npe_tpu_torch/csrc/mdblock_bf16.cu` (its header has the design):
a prologue launch writes MDCL1's input lrelu(BN0(x)) in bf16, pixel-major,
once per element; each MDCL runs on wgmma with both operands brought into
shared memory by the tensor memory accelerator, the activations as one halo
tile per 8x8 patch and 64-channel chunk shared by all taps, the taps as they
lie. Its tiles and slices come from `bf16_plan`. `mdblock_fused.launches` counts the float32 form's
calls, `mdblock_fused.launches_bf16` the bf16 form's.
"""

import ctypes
import functools
from collections import namedtuple

import torch
import torch.nn.functional as F

from npe_tpu_torch.ops.kernels import build
from npe_tpu_torch.ops.kernels.rgb_beta_tail import check_tensors, count_launch, sum_dtype, vjp_of_plain

SOURCE = "npe_tpu_torch/csrc/mdblock.cu"
BF16_SOURCE = "npe_tpu_torch/csrc/mdblock_bf16.cu"
REPLACES = "npe_tpu/ops/pallas/mdcl_kernels.py:119"
TILE_PIXELS = 64  # the kernel's output tile: 64 pixels x 128 channels
TILE_CHANNELS = 128
CHANNEL_STEP = 16  # input channels of one step of its inner loop
MAX_BRANCHES = 8
# How many of the kernel's 256-thread blocks an SM holds at once:
# __launch_bounds__(256, 2) keeps its registers to 128 a thread, and a block
# has 52 KB of shared memory.
BLOCKS_PER_SM = 2
# The bf16 kernel: a warpgroup takes a patch of 64 pixels (8x8 in halo mode)
# by 128 or 256 output channels, over units of one tap by 64 input channels
BF16_CHANNEL_STEP = 64
BF16_TILE_CHANNELS = 128  # 256 where the plan takes two patches a block and C >= 256
BF16_MIN_UNITS = 4  # units a slice takes at least: the tap ring's depth
BF16_STAGES, BF16_ROWS_STAGE_BYTES = 4, 64 * 64 * 2
SMEM_PER_BLOCK = 227 * 1024  # the most dynamic shared memory a block may take on the H100
SMEM_PER_SM = 228 * 1024  # what the SM has for its blocks, 1 KB of it reserved per block


def dilations(scales):
    """The 3x3 branches of an MDCL as dilations: the base filter (1; the
    scale-0 branch is folded into its centre), then each scale > 0."""
    return (1,) + tuple(s for s in scales if s > 0)


def tap_offsets(scales):
    """(dy, dx) of every tap, in the order of `stack_mdcl_taps`: nine per
    branch of `dilations(scales)`. The centre appears once per branch."""
    return tuple((dy, dx) for d in dilations(scales) for dy in (-d, 0, d) for dx in (-d, 0, d))


def stack_mdcl_taps(w, coeff_base, scale_coeffs, scales):
    """The (T, Cin, Cout) per-tap matrices for `tap_offsets(scales)`, with the
    per-output-channel coefficients folded in and the scale-0 branch (the
    mean of the nine taps) added to the base filter's centre. w: (nf, ni, 3,
    3) shared filter; scale_coeffs: {scale: (nf,)}. Built from torch ops, so
    gradients reach the weights; one transposed copy of w and one product."""
    nf, ni = w.shape[:2]
    w9 = w.permute(2, 3, 1, 0).reshape(9, ni, nf)
    coeffs = torch.stack([coeff_base] + [scale_coeffs[s] for s in scales if s > 0])  # (B, nf)
    taps = coeffs[:, None, None, :] * w9  # (B, 9, ni, nf)
    if 0 in scales:
        taps[0, 4] += w9.mean(dim=0) * scale_coeffs[0]
    return taps.reshape(-1, ni, nf)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _mdcl_taps(h, taps, offs):
    """sum_t shift_t(h) @ taps[t] with a zero border. h: (N, Cin, H, W);
    taps: (T, Cin, Cout). One product per tap."""
    n, c, hh, ww = h.shape
    pad = max(abs(o) for off in offs for o in off)
    hp = F.pad(h, (pad, pad, pad, pad))
    out = 0.0
    for t, (dy, dx) in enumerate(offs):
        sl = hp[:, :, pad + dy : pad + dy + hh, pad + dx : pad + dx + ww]
        out = out + taps[t].t() @ sl.reshape(n, c, hh * ww)
    return out.reshape(n, taps.shape[2], hh, ww)


def mdblock_taps_reference(x, taps1, taps2, affines, scales):
    """Plain version of exactly what the kernel computes, and its backward.
    x: (N, C, H, W); taps1, taps2: (T, C, C); affines: (6, C). In bfloat16
    (x and the taps; the affines stay float32) it rounds where npe_tpu's
    kernel rounds: x is widened to float32, each MDCL's input is rounded to
    bf16 just before its products (after BN0's and BN1's affine and lrelu),
    the sums, affines and the residual x + h are float32, and the output is
    rounded to bf16. In float32 every cast is the identity."""
    mx, acc = x.dtype, sum_dtype(x.dtype)
    offs = tap_offsets(scales)
    s0, t0, s1, t1, s2, t2 = (a[None, :, None, None] for a in affines)
    xf = x.to(acc)
    h = _lrelu(xf * s0 + t0)
    h = _lrelu(_mdcl_taps(h.to(mx).to(acc), taps1.to(acc), offs) * s1 + t1)
    h = _mdcl_taps(h.to(mx).to(acc), taps2.to(acc), offs)
    return _lrelu((xf + h) * s2 + t2).to(mx)


def tf32_split(x):
    """(hi, lo) with hi = TF32(x) and lo = TF32(x - hi), as the kernel splits
    each operand: `cvt.rna.tf32.f32` keeps 10 of float32's 23 mantissa bits,
    rounding to nearest with ties away from zero (add half of the last kept
    bit to the magnitude, then clear the 13 dropped bits). float32 in and
    out; hi + lo holds x to about 21 bits. Used by the tests."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = tf32(x)
    return hi, tf32(x - hi)


def inner_splits(batch, tiles, units, sm_count):
    """How many slices an MDCL's inner dimension (taps x steps of 16 input
    channels = `units`) is cut into: the largest divisor of `units` that
    still leaves all blocks (batch x tiles x slices) running at once, one
    wave of BLOCKS_PER_SM a multiprocessor. One image of full IAN takes 64,
    27 and 12 slices in its three blocks, a batch of 128 one."""
    most = max(1, BLOCKS_PER_SM * sm_count // (batch * tiles))
    return max(d for d in range(1, min(most, units) + 1) if units % d == 0)


BF16Plan = namedtuple("BF16Plan", "halo sub_tiles tile_channels splits")


def bf16_smem_bytes(sub_tiles, halo, radius, tile_channels=BF16_TILE_CHANNELS):
    """Dynamic shared memory of one block of the bf16 kernel: the tap ring
    (64 input by `tile_channels` output channels a stage), then per patch
    two halo tiles of (8 + 2 radius)^2 pixels by 64 channels, or (rows mode)
    a ring of 64-pixel windows, then an 8-byte barrier a stage."""
    acts = 2 * (8 + 2 * radius) ** 2 * BF16_CHANNEL_STEP * 2 if halo else BF16_STAGES * BF16_ROWS_STAGE_BYTES
    return BF16_STAGES * (BF16_CHANNEL_STEP * tile_channels * 2 + 8) + sub_tiles * acts


def bf16_plan(batch, channels, height, width, scales, sm_count):
    """How the bf16 kernel cuts one MDCL (a stated rule, the same on every
    call of a shape):
    - halo: 8x8 patches that share one halo tile among all taps, when both
      sides are multiples of 8 and two patches' halo tiles fit a block;
      else rows mode, 64 consecutive pixels with a window staged per tap;
    - sub_tiles: two patches a block (two warpgroups over the same tap
      stages, half the taps' traffic) once the output tiles (patches x
      128-channel tiles) give every SM two; else one;
    - tile_channels: with two patches a block and C >= 256, 256 output
      channels a block (wgmma's widest N: half the products' issue a
      multiply-add), where its shared memory fits; else 128;
    - splits: slices of the inner dimension (chunks of 64 channels x taps)
      so that the blocks fill the card's slots (one block of two patches or,
      where shared memory allows, two of one a multiprocessor), each slice
      at least BF16_MIN_UNITS units; one once the batch fills the card."""
    radius = max(dilations(scales))
    halo = height % 8 == 0 and width % 8 == 0 and bf16_smem_bytes(2, True, radius) <= SMEM_PER_BLOCK
    patches = batch * height * width // TILE_PIXELS
    sub = 2 if patches * -(-channels // BF16_TILE_CHANNELS) >= 2 * sm_count else 1
    wide = sub == 2 and channels >= 256 and bf16_smem_bytes(2, halo, radius, 256) <= SMEM_PER_BLOCK
    tile_channels = 256 if wide else BF16_TILE_CHANNELS
    per_sm = 1 if sub == 2 else min(2, SMEM_PER_SM // (bf16_smem_bytes(1, halo, radius) + 1024))
    blocks = -(-patches // sub) * -(-channels // tile_channels)
    units = -(-channels // BF16_CHANNEL_STEP) * 9 * len(dilations(scales))
    splits = max(1, min(units // BF16_MIN_UNITS, per_sm * sm_count // blocks))
    return BF16Plan(halo, sub, tile_channels, splits)


@functools.cache
def _entry(bf16):
    if bf16:
        fn = build.load("mdblock_bf16").npe_mdblock_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    else:
        fn = build.load("mdblock").npe_mdblock
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_float32(x, taps1, taps2, affines, scales):
    """The float32 kernel's call: scratch for h1 and, when `inner_splits`
    slices, float32 partial sums. Returns (the output, the C function's
    return code)."""
    n, c, h, w = x.shape
    branches = dilations(scales)
    tiles = (h * w // TILE_PIXELS) * -(-c // TILE_CHANNELS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = inner_splits(n, tiles, 9 * len(branches) * c // CHANNEL_STEP, sms)
    h1, out = torch.empty_like(x), torch.empty_like(x)
    partial = torch.empty((n, splits, c, h, w), dtype=torch.float32, device=x.device) if splits > 1 else None
    with torch.cuda.device(x.device):
        rc = _entry(False)(
            x.data_ptr(), taps1.data_ptr(), taps2.data_ptr(), affines.data_ptr(),
            h1.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
            n, c, h, w, len(branches), (ctypes.c_int * len(branches))(*branches), splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return out, rc


def _launch_bf16(x, taps1, taps2, affines, scales):
    """The bf16 kernel's call: scratch for MDCL1's input and h1 (bf16,
    pixel-major), float32 partial sums when `bf16_plan` slices; the taps as
    they lie. Returns (the output, the C function's return code)."""
    n, c, h, w = x.shape
    branches = dilations(scales)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = bf16_plan(n, c, h, w, scales, sms)
    act, h1, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    partial = torch.empty((n, plan.splits, c, h, w), dtype=torch.float32, device=x.device) if plan.splits > 1 else None
    with torch.cuda.device(x.device):
        rc = _entry(True)(
            x.data_ptr(), taps1.data_ptr(), taps2.data_ptr(), affines.data_ptr(), act.data_ptr(), h1.data_ptr(),
            None if partial is None else partial.data_ptr(), out.data_ptr(), n, c, h, w, len(branches),
            (ctypes.c_int * len(branches))(*branches), plan.sub_tiles, int(plan.halo), plan.tile_channels, plan.splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return out, rc


class _MDBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps1, taps2, affines, scales):
        ctx.save_for_backward(x, taps1, taps2, affines)
        ctx.scales = scales
        launch = _launch_bf16 if x.dtype == torch.bfloat16 else _launch_float32
        out, rc = launch(x, taps1, taps2, affines, scales)
        if rc != 0:
            raise RuntimeError(f"mdblock kernel launch failed with CUDA error {rc}")
        count_launch(mdblock_fused, x.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        plain = functools.partial(mdblock_taps_reference, scales=ctx.scales)
        return vjp_of_plain(plain, ctx.needs_input_grad[:4], ctx.saved_tensors, g) + (None,)


def mdblock_fused(x, taps1, taps2, affines, scales):
    """Fused inference MDBLOCK. x: (N, C, H, W), C a multiple of 16 and
    H*W a multiple of 64; taps1, taps2: (T, C, C) from `stack_mdcl_taps`, in
    x's dtype, float32 (the float32 form) or bfloat16 (the bf16 form:
    `mdblock_taps_reference` says where it rounds); affines: (6, C) float32,
    rows s0, t0, s1, t1, s2, t2; scales: the MDCLs' scale list, e.g. (0, 2,
    3), not tensor data. Returns (N, C, H, W) in x's dtype. The gradient is
    the plain version's, and only the inputs that need one get one: the edit
    step asks for x's alone, so no tap gradient is built."""
    scales = tuple(int(s) for s in scales)
    branches = dilations(scales)
    if x.ndim != 4 or x.shape[0] < 1 or x.shape[1] % CHANNEL_STEP or (x.shape[2] * x.shape[3]) % TILE_PIXELS:
        raise ValueError(
            f"mdblock_fused wants (N, C, H, W) with C a multiple of {CHANNEL_STEP} and H*W a multiple "
            f"of {TILE_PIXELS}, got {tuple(x.shape)}"
        )
    if len(branches) > MAX_BRANCHES or min(scales, default=0) < 0:
        raise ValueError(f"mdblock_fused takes scales >= 0, at most {MAX_BRANCHES - 1} of them dilated; got {scales}")
    c = x.shape[1]
    check_tensors(
        "mdblock_fused",
        {"x": x, "taps1": taps1, "taps2": taps2, "affines": affines},
        {"x": x.shape, "taps1": (9 * len(branches), c, c), "taps2": (9 * len(branches), c, c),
         "affines": (6, c)},
        float32=("affines",),
    )
    if x.device.type == "cpu":
        return mdblock_taps_reference(x, taps1, taps2, affines, scales)
    return _MDBlock.apply(x, taps1, taps2, affines, scales)


mdblock_fused.launches = 0
mdblock_fused.launches_bf16 = 0
