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
sums in a fixed order. `mdblock_fused.launches` counts calls.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from npe_tpu_torch.ops.kernels import build
from npe_tpu_torch.ops.kernels.rgb_beta_tail import check_tensors, vjp_of_plain

SOURCE = "npe_tpu_torch/csrc/mdblock.cu"
REPLACES = "npe_tpu/ops/pallas/mdcl_kernels.py:119"
TILE_PIXELS = 64  # the kernel's output tile: 64 pixels x 128 channels
TILE_CHANNELS = 128
CHANNEL_STEP = 16  # input channels of one step of its inner loop
MAX_BRANCHES = 8
# How many of the kernel's 256-thread blocks an SM holds at once:
# __launch_bounds__(256, 2) keeps its registers to 128 a thread, and a block
# has 52 KB of shared memory.
BLOCKS_PER_SM = 2


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
    x: (N, C, H, W); taps1, taps2: (T, C, C); affines: (6, C)."""
    offs = tap_offsets(scales)
    s0, t0, s1, t1, s2, t2 = (a[None, :, None, None] for a in affines)
    h = _lrelu(x * s0 + t0)
    h = _lrelu(_mdcl_taps(h, taps1, offs) * s1 + t1)
    h = _mdcl_taps(h, taps2, offs)
    return _lrelu((x + h) * s2 + t2)


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


@functools.cache
def _entry():
    fn = build.load("mdblock").npe_mdblock
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _MDBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps1, taps2, affines, scales):
        ctx.save_for_backward(x, taps1, taps2, affines)
        ctx.scales = scales
        n, c, h, w = x.shape
        branches = dilations(scales)
        tiles = (h * w // TILE_PIXELS) * -(-c // TILE_CHANNELS)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = inner_splits(n, tiles, 9 * len(branches) * c // CHANNEL_STEP, sms)
        h1, out = torch.empty_like(x), torch.empty_like(x)
        partial = x.new_empty((n, splits, c, h, w)) if splits > 1 else None
        with torch.cuda.device(x.device):
            rc = _entry()(
                x.data_ptr(), taps1.data_ptr(), taps2.data_ptr(), affines.data_ptr(),
                h1.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
                n, c, h, w, len(branches), (ctypes.c_int * len(branches))(*branches), splits,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"mdblock kernel launch failed with CUDA error {rc}")
        mdblock_fused.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        plain = functools.partial(mdblock_taps_reference, scales=ctx.scales)
        return vjp_of_plain(plain, ctx.needs_input_grad[:4], ctx.saved_tensors, g) + (None,)


def mdblock_fused(x, taps1, taps2, affines, scales):
    """Fused inference MDBLOCK. x: (N, C, H, W) float32, C a multiple of 16
    and H*W a multiple of 64; taps1, taps2: (T, C, C) from `stack_mdcl_taps`;
    affines: (6, C), rows s0, t0, s1, t1, s2, t2; scales: the MDCLs' scale
    list, e.g. (0, 2, 3), not tensor data. Returns (N, C, H, W). The gradient
    is the plain version's, and only the inputs that need one get one: the
    edit step asks for x's alone, so no tap gradient is built."""
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
    )
    if x.device.type == "cpu":
        return mdblock_taps_reference(x, taps1, taps2, affines, scales)
    return _MDBlock.apply(x, taps1, taps2, affines, scales)


mdblock_fused.launches = 0
