"""The whole RGB-Beta head in one kernel call: the trunk MDCLs R / G_a / B_a
as a direct multiscale conv over the decoder's last feature map, then the
autoregressive tail of `rgb_beta_tail` (reference `IAN.py:183-207`).

Replaces the Pallas TPU kernel
`npe_tpu/ops/pallas/mdcl_kernels.py:rgb_beta_head_pallas`. The source is
`npe_tpu_torch/csrc/rgb_beta_head.cu` (its header says what bounds it and
how the work is split); `rgb_beta_head_reference` is the plain PyTorch
version.

Layout. x is the feature map as the decoder leaves it, (N, C, H, 64) NCHW
with H a multiple of 8. The trunk taps are the three MDCLs' stacked taps
(`mdblock.stack_mdcl_taps`: R, G_a, B_a joined along the output axis in that
order), (T, C, 6) for `tap_offsets(scales)`: T = 36 at scales 2/3/4, nine
taps per dilation 1, 2, 3, 4 with the centre once per branch. The tail's tap
matrices are those of `rgb_beta_tail.pack_head_taps`: G_b (9, 32, 32), B_b
(9, 64, 32). The output is the image, (N, 3, H, 64).

One call is two or three launches on the same stream: the trunk, cut into
bands of four rows and slices of the input channels (`head_slices`) so that
a single image still spreads over the card, into the tail's space-to-depth
trunk; with more than one slice, a pass that adds the slices' partial sums
in a fixed order (so the result does not change from run to run); then the
tail kernel of `rgb_beta_tail`, which finishes the head. In both forms, float32
and bfloat16 (picked by the tensors' dtype), the trunk between the launches is
float32. `rgb_beta_head.launches` counts the float32 form's calls,
`rgb_beta_head.launches_bf16` the bf16 form's.

x's gradient (npe_tpu's custom VJP, `_head_bwd`, for x) is hand-written too,
in both forms (`npe_rgb_beta_head_bwd[_bf16]`): the tail's backward passes
(`rgb_beta_tail`'s, float32 or bf16 over the float32 trunk the forward keeps
when x requires a gradient) into the trunk's float32 gradient, then
`head_trunk_bwd_kernel`, the trunk's transposed multiscale conv, into dx.
`rgb_beta_head_backward_reference` is its plain version;
`rgb_beta_head.launches_bwd` and `.launches_bwd_bf16` count its calls. The
taps' gradients stay the plain version's VJP: no path asks for them
(training runs the hybrid head; the API and the editor ask for x's alone).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from npe_tpu_torch.ops.kernels import add_launches, build, current_tally
from npe_tpu_torch.ops.kernels.mdblock import dilations, mdcl_transposed, tap_offsets
from npe_tpu_torch.ops.kernels.rgb_beta_tail import (
    RR, SCRATCH_PLANES, check_tensors, count_launch, rgb_beta_tail_backward_reference, rgb_beta_tail_reference,
    sum_dtype, tail_rows, vjp_of_plain,
)

SOURCE = "npe_tpu_torch/csrc/rgb_beta_head.cu"
REPLACES = "npe_tpu/ops/pallas/mdcl_kernels.py:275"
REPLACES_BWD = "npe_tpu/ops/pallas/mdcl_kernels.py:446"  # `_head_bwd`, the custom VJP's backward
R = 4
WIDTH = 64  # a band is four rows of 64 pixels, the tail's 16 cells
BAND_ROWS = 4
MAX_DILATION = 4  # the trunk kernel's halo
MAX_BRANCHES = 4
MAX_SLICES = 8
CO = 6


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)  # as `ops.conv._s2d_gather`
def _placement(scales, device):
    """(T, K*K) 0/1 matrix that puts tap t of `tap_offsets(scales)` at its
    offset in a K x K kernel, K = 2 * max dilation + 1."""
    offs = tap_offsets(scales)
    pad = max(dilations(scales))
    size = 2 * pad + 1
    p = torch.zeros(len(offs), size * size)
    for t, (dy, dx) in enumerate(offs):
        p[t, (pad + dy) * size + pad + dx] = 1.0
    return p.to(device)


def trunk_kernel(trunk_taps, scales):
    """The stacked taps (T, C, 6) as one dense conv kernel (6, C, K, K):
    each tap's matrix at its offset, the centres added up. One product, so
    gradients reach the taps."""
    t, c, co = trunk_taps.shape
    k = trunk_taps.permute(2, 1, 0) @ _placement(tuple(scales), trunk_taps.device).to(trunk_taps.dtype)
    size = 2 * max(dilations(scales)) + 1
    return k.reshape(co, c, size, size)


def trunk_reference(x, trunk_taps, scales):
    """The plain trunk: the sum over the taps of the shifted x times the
    tap's matrix with a zero border, as one conv with the taps placed at
    their offsets (`trunk_kernel`; its backward is a few launches, where one
    product per tap would be dozens), packed by `pixel_unshuffle` into the
    tail's component-major channels (component * 16 + position): (N, 96,
    H/4, W/4), float32 for bf16 operands (npe_tpu never rounds it)."""
    acc = sum_dtype(x.dtype)
    k = trunk_kernel(trunk_taps.to(acc), scales)
    return F.pixel_unshuffle(F.conv2d(x.to(acc), k, padding=k.shape[-1] // 2), R)


def rgb_beta_head_reference(x, trunk_taps, tg_taps, tb_taps, scales):
    """Plain version: `trunk_reference`, the tail, unpacked. x: (N, C, H, W);
    returns (N, 3, H, W). In bfloat16 (x and the taps) the trunk takes the
    bf16 operands and stays float32, never rounded, as in npe_tpu's kernel;
    the tail rounds as `rgb_beta_tail_reference` says; the image is bf16. In
    float32 every cast is the identity."""
    return F.pixel_shuffle(rgb_beta_tail_reference(trunk_reference(x, trunk_taps, scales), tg_taps, tb_taps), R)


def rgb_beta_head_backward_reference(g, trunk, trunk_taps, tg_taps, tb_taps, scales):
    """Plain version of exactly what x's backward kernels compute: x's
    gradient of `rgb_beta_head_reference` for the cotangent g of the image,
    given the forward's trunk (`trunk_reference`). The tail's backward for
    the trunk alone (`rgb_beta_tail_backward_reference` over the cotangent
    packed as the tail's output), unpacked, then the trunk's transposed
    MDCL (`mdcl_transposed`): dx[c, p] = sum_t sum_k d6[k, p - offset_t]
    taps[t, c, k]. In bfloat16 the trunk and its gradient are float32 (the
    tail's bf16 form over a float32 trunk) and dx is rounded to bf16 once at
    the end, where the VJP rounds it."""
    g_cells = F.pixel_unshuffle(g, R)
    dtrunk = rgb_beta_tail_backward_reference(g_cells, trunk, tg_taps, tb_taps, (True, False, False))[0]
    dx = mdcl_transposed(F.pixel_shuffle(dtrunk, R), trunk_taps.to(dtrunk.dtype), tap_offsets(scales))
    return dx.to(trunk_taps.dtype)


def head_slices(batch, bands, channels, sm_count):
    """How many slices of the input channels the trunk is cut into: the
    most, up to MAX_SLICES and `channels`, that keep batch x bands x slices
    blocks within two a multiprocessor. One image (16 bands) takes 8, a
    batch of 4 four, a batch of 8 two, a batch of 9 or more one."""
    return max(1, min(MAX_SLICES, channels, 2 * sm_count // (batch * bands)))


@functools.cache
def _entry(bf16):
    lib = build.load("rgb_beta_head")
    fn = lib.npe_rgb_beta_head_bf16 if bf16 else lib.npe_rgb_beta_head
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _trunk_entry(bf16):
    lib = build.load("rgb_beta_head")
    fn = lib.npe_rgb_beta_head_trunk_bf16 if bf16 else lib.npe_rgb_beta_head_trunk
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] + \
        [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trunk_only(x, trunk_taps, scales, slices=None):
    """The kernel's trunk alone (its launch, and with more than one slice
    the pass that adds them), for checking and timing it on the card; not a
    path of the models, not counted in `launches`. `slices` defaults to
    `head_slices`. Returns the tail's (N, 96, H/4, 16) space-to-depth trunk,
    `pixel_unshuffle` of the plain version's trunk, float32 in both forms."""
    n, c, h, w = x.shape
    dil = dilations(scales)
    trunk = torch.empty((n, CO * RR, h // R, w // R), dtype=torch.float32, device=x.device)
    slices = slices or head_slices(n, h // BAND_ROWS, c, torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = trunk.new_empty((n, slices) + trunk.shape[1:]) if slices > 1 else None
    with torch.cuda.device(x.device):
        rc = _trunk_entry(x.dtype == torch.bfloat16)(
            x.data_ptr(), trunk_taps.data_ptr(), trunk.data_ptr(), None if partial is None else partial.data_ptr(),
            n, c, h // R, len(dil), (ctypes.c_int * len(dil))(*dil), slices,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rgb_beta_head's trunk failed to launch with CUDA error {rc}")
    return trunk


@functools.cache
def _bwd_entry(bf16):
    lib = build.load("rgb_beta_head")
    fn = lib.npe_rgb_beta_head_bwd_bf16 if bf16 else lib.npe_rgb_beta_head_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, trunk_taps, tg_taps, tb_taps, scales):
    """One call of the kernel in x's form: returns (the image, the float32
    (N, 96, H/4, 16) trunk it wrote between its launches). Checked by the
    caller; not counted."""
    n, c, h, w = x.shape
    cells_h = h // R
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    dil = dilations(scales)
    slices = head_slices(n, h // BAND_ROWS, c, sms)
    # float32 in both forms: npe_tpu's kernel never rounds the trunk
    trunk = torch.empty((n, CO * RR, cells_h, w // R), dtype=torch.float32, device=x.device)
    partial = trunk.new_empty((n, slices) + trunk.shape[1:]) if slices > 1 else None
    out = torch.empty((n, 3, h, w), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _entry(x.dtype == torch.bfloat16)(
            x.data_ptr(), trunk_taps.data_ptr(), tg_taps.data_ptr(), tb_taps.data_ptr(), trunk.data_ptr(),
            None if partial is None else partial.data_ptr(), out.data_ptr(), n, c, cells_h, len(dil),
            (ctypes.c_int * len(dil))(*dil), slices, tail_rows(n, cells_h, w // R, sms),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rgb_beta_head kernel launch failed with CUDA error {rc}")
    return out, trunk


def _launch_bwd(g, x, trunk, trunk_taps, tg_taps, tb_taps, scales):
    """One call of x's backward kernels in x's form for the cotangent g (the
    image's shape and dtype, contiguous), over the forward's float32 trunk;
    scratch for the tail's passes and the trunk's gradient. Returns dx.
    Checked by the caller; not counted."""
    n, c, h, w = x.shape
    cells_h = h // R
    dil = dilations(scales)
    scratch = torch.empty((n, SCRATCH_PLANES, cells_h, w // R), dtype=torch.float32, device=x.device)
    dtrunk, dx = torch.empty_like(trunk), torch.empty_like(x)
    rows = tail_rows(n, cells_h, w // R, torch.cuda.get_device_properties(x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        rc = _bwd_entry(x.dtype == torch.bfloat16)(
            g.data_ptr(), trunk.data_ptr(), trunk_taps.data_ptr(), tg_taps.data_ptr(), tb_taps.data_ptr(),
            scratch.data_ptr(), dtrunk.data_ptr(), dx.data_ptr(), n, c, cells_h, len(dil),
            (ctypes.c_int * len(dil))(*dil), rows, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rgb_beta_head backward kernel launch failed with CUDA error {rc}")
    return dx


class _Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, trunk_taps, tg_taps, tb_taps, scales):
        out, trunk = _launch(x, trunk_taps, tg_taps, tb_taps, scales)
        count_launch(rgb_beta_head, x.dtype)
        # the trunk only where x requires a gradient; under no_grad or
        # inference_mode autograd drops ctx, and all it saved, as this call returns
        ctx.save_for_backward(x, trunk_taps, tg_taps, tb_taps, *((trunk,) if ctx.needs_input_grad[0] else ()))
        ctx.scales = scales
        # autograd may run the backward on a thread of its own: it counts where the forward did
        ctx.tally = current_tally()
        return out

    @staticmethod
    def backward(ctx, g):
        x, trunk_taps, tg_taps, tb_taps, *kept = ctx.saved_tensors
        need_x, *need_rest = ctx.needs_input_grad[:4]
        dx = None
        if need_x:
            dx = _launch_bwd(g.to(x.dtype).contiguous(), x, kept[0], trunk_taps, tg_taps, tb_taps, ctx.scales)
            add_launches(rgb_beta_head, "launches_bwd_bf16" if x.dtype == torch.bfloat16 else "launches_bwd",
                         tally=ctx.tally)
        rest = (None,) * 3
        if any(need_rest):  # the taps' gradients: the plain version's VJP
            def plain(*tensors):
                return rgb_beta_head_reference(*tensors, ctx.scales)

            rest = vjp_of_plain(plain, (False, *need_rest), (x, trunk_taps, tg_taps, tb_taps), g)[1:]
        return (dx, *rest, None)


def rgb_beta_head(x, trunk_taps, tg_taps, tb_taps, scales):
    """Fused RGB-Beta head. x: (N, C, H, 64) with H a multiple of 8;
    trunk_taps (T, C, 6) for `tap_offsets(scales)` (every dilation at most
    4, at most 4 branches), tg_taps (9, 32, 32), tb_taps (9, 64, 32) from
    `pack_head_taps`; all float32 (the float32 form) or all bfloat16 (the
    bf16 form: `rgb_beta_head_reference` says where it rounds). Returns the
    image (N, 3, H, 64) in that dtype. x's gradient comes from the backward
    kernels (`rgb_beta_head_backward_reference` is their plain version), the
    taps' from the plain version's VJP."""
    if x.ndim != 4 or x.shape[0] < 1 or x.shape[1] < 1 or x.shape[2] % (2 * R) or x.shape[3] != WIDTH:
        raise ValueError(f"rgb_beta_head wants (N, C, H, {WIDTH}) with H a multiple of {2 * R}, got {tuple(x.shape)}")
    scales = tuple(scales)
    dil = dilations(scales)
    if len(dil) > MAX_BRANCHES or max(dil) > MAX_DILATION:
        raise ValueError(f"rgb_beta_head takes at most {MAX_BRANCHES} dilations of at most {MAX_DILATION}, "
                         f"got scales {list(scales)}")
    check_tensors(
        "rgb_beta_head",
        {"x": x, "trunk_taps": trunk_taps, "tg_taps": tg_taps, "tb_taps": tb_taps},
        {"x": x.shape, "trunk_taps": (9 * len(dil), x.shape[1], CO), "tg_taps": (9, 2 * RR, 2 * RR),
         "tb_taps": (9, 4 * RR, 2 * RR)},
    )
    if x.device.type == "cpu":
        return rgb_beta_head_reference(x, trunk_taps, tg_taps, tb_taps, scales)
    return _Head.apply(x, trunk_taps, tg_taps, tb_taps, scales)


rgb_beta_head.launches = 0
rgb_beta_head.launches_bf16 = 0
rgb_beta_head.launches_bwd = 0
rgb_beta_head.launches_bwd_bf16 = 0
