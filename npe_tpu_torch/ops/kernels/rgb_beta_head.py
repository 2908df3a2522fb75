"""The whole RGB-Beta head in one kernel call: the trunk MDCLs R / G_a / B_a
over the decoder's last feature map as nine tap products in space-to-depth(4)
form, then the autoregressive tail of `rgb_beta_tail` (reference
`IAN.py:183-207`).

Replaces the Pallas TPU kernel
`npe_tpu/ops/pallas/mdcl_kernels.py:rgb_beta_head_pallas`. The source is
`npe_tpu_torch/csrc/rgb_beta_head.cu` (its header says what bounds it and
how the work is split); `rgb_beta_head_reference_packed` is the plain
PyTorch version.

Layout. x is the feature map as the decoder leaves it, (N, C, H, 64) NCHW
with H a multiple of 16; the kernel reads it in space-to-depth order itself,
so no packed copy of x is made. The tap matrices are those of
`rgb_beta_tail.pack_head_taps`: trunk (9, 16*C, 96), G_b (9, 32, 32), B_b
(9, 64, 32), (t, in, out) row-major with component-major channels. The
output is the image, (N, 3, H, 64).

One call is two or three launches on the same stream: the trunk product,
split over cell tiles and over slices of its inner dimension so that a single
image still spreads over the card; with more than one slice, a pass that adds
the slices' partial sums in a fixed order (so the result does not change from
run to run); and the tail kernel of `rgb_beta_tail`, which finishes the head.
`rgb_beta_head.launches` counts calls.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from npe_tpu_torch.ops.kernels import build
from npe_tpu_torch.ops.kernels.rgb_beta_tail import (
    RR, check_tensors, rgb_beta_tail_reference, tail_rows, tap_conv, vjp_of_plain,
)

SOURCE = "npe_tpu_torch/csrc/rgb_beta_head.cu"
REPLACES = "npe_tpu/ops/pallas/mdcl_kernels.py:275"
R = 4
WIDTH = 64  # the trunk kernel's tiles are four rows of 16 cells
MAX_SPLITS = 36


def rgb_beta_head_reference_packed(x, tr_taps, tg_taps, tb_taps):
    """Plain version: the packed head over tap matrices. x: (N, C, H, W);
    returns (N, 3, H, W)."""
    trunk = tap_conv(F.pixel_unshuffle(x, R), tr_taps)
    return F.pixel_shuffle(rgb_beta_tail_reference(trunk, tg_taps, tb_taps), R)


def trunk_splits(batch, tiles, units, sm_count):
    """How many slices the trunk's inner dimension (9 taps x C/2 channel
    pairs = `units`) is cut into: the smallest divisor of `units` that gives
    the card two blocks per SM, at most MAX_SPLITS. One image takes 36
    slices, a large batch one."""
    want = -(-2 * sm_count // (batch * tiles))
    divisors = [d for d in range(1, MAX_SPLITS + 1) if units % d == 0]
    return next((d for d in divisors if d >= want), divisors[-1])


@functools.cache
def _entry():
    fn = build.load("rgb_beta_head").npe_rgb_beta_head
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tr_taps, tg_taps, tb_taps):
        ctx.save_for_backward(x, tr_taps, tg_taps, tb_taps)
        n, c, h, w = x.shape
        cells_h = h // R
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = trunk_splits(n, cells_h // 4, 9 * c // 2, sms)
        trunk = torch.empty((n, 6 * RR, cells_h, w // R), dtype=x.dtype, device=x.device)
        partial = trunk.new_empty((n, splits) + trunk.shape[1:]) if splits > 1 else None
        out = torch.empty((n, 3, h, w), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            rc = _entry()(
                x.data_ptr(), tr_taps.data_ptr(), tg_taps.data_ptr(), tb_taps.data_ptr(),
                trunk.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
                n, c, cells_h, splits, tail_rows(n, cells_h, w // R, sms),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"rgb_beta_head kernel launch failed with CUDA error {rc}")
        rgb_beta_head.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return vjp_of_plain(rgb_beta_head_reference_packed, ctx.needs_input_grad, ctx.saved_tensors, g)


def rgb_beta_head(x, tr_taps, tg_taps, tb_taps):
    """Fused RGB-Beta head. x: (N, C, H, 64) float32 with C even and H a
    multiple of 16; tr_taps (9, 16*C, 96), tg_taps (9, 32, 32), tb_taps
    (9, 64, 32) from `pack_head_taps`. Returns the image (N, 3, H, 64)."""
    if x.ndim != 4 or x.shape[0] < 1 or x.shape[1] % 2 or x.shape[2] % (4 * R) or x.shape[3] != WIDTH:
        raise ValueError(
            f"rgb_beta_head wants (N, C, H, {WIDTH}) with C even and H a multiple of {4 * R}, "
            f"got {tuple(x.shape)}"
        )
    c = x.shape[1]
    check_tensors(
        "rgb_beta_head",
        {"x": x, "tr_taps": tr_taps, "tg_taps": tg_taps, "tb_taps": tb_taps},
        {"x": x.shape, "tr_taps": (9, RR * c, 6 * RR), "tg_taps": (9, 2 * RR, 2 * RR),
         "tb_taps": (9, 4 * RR, 2 * RR)},
    )
    if x.device.type == "cpu":
        return rgb_beta_head_reference_packed(x, tr_taps, tg_taps, tb_taps)
    return _Head.apply(x, tr_taps, tg_taps, tb_taps)


rgb_beta_head.launches = 0
