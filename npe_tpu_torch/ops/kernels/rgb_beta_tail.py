"""The RGB-Beta head's autoregressive tail (reference `IAN.py:189-207`):
sigmoid of the R pre-activations, the G_b MDCL over R, sigmoid, the B_b MDCL
over [R, G], sigmoid, and the three Beta means, in one kernel.

Replaces the Pallas TPU kernel
`npe_tpu/ops/pallas/mdcl_kernels.py:rgb_beta_tail_pallas`. The kernel is
`npe_tpu_torch/csrc/rgb_beta_tail.cu` (device code in `rgb_beta_tail.cuh`,
whose header says what bounds it, how an image is cut over blocks and how it
is laid out); `rgb_beta_tail_reference` is its plain PyTorch version.

Layout. Everything is in space-to-depth(r = 4) form, NCHW, component-major:
a map with c components is (N, c*rr, H/4, W/4), rr = 16, with plane
c*rr + p*4 + q holding component c of in-block pixel (p, q)
(`ops.conv.space_to_depth`). The trunk has the six components (R_alpha,
R_beta, G_alpha, G_beta, B_alpha, B_beta), the output the three Beta means
(R, G, B); `depth_to_space(out, 4)` is the image. Each plane is contiguous,
so neighbouring threads read neighbouring cells. npe_tpu's kernel has the
same component-major channels, but last (NHWC); the port gets them from the
packed conv's output channels for free, because its s2d is component-major
on both sides (`ops.conv.pack_kernel_s2d`). Tap matrices are (9, in, out)
row-major, tap t = 3*(dy + 1) + (dx + 1), from `pack_head_taps`.

`rgb_beta_tail` runs the plain version for CPU tensors; for CUDA tensors it
launches the kernel, or raises. The kernel gives each block a group of cell
rows of an image (`tail_rows`) and recomputes R and G on the two rows around
them. Its backward is the plain version's, as
npe_tpu's custom VJP is. It has a float32 and a bfloat16 form, picked by the
dtype of the tensors it is given (`check_tensors`; the bf16 form rounds where
npe_tpu's kernel rounds under bf16); `rgb_beta_tail.launches` counts the
float32 form's launches, `rgb_beta_tail.launches_bf16` the bf16 form's.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from npe_tpu_torch.ops.beta import beta_mean
from npe_tpu_torch.ops.conv import pack_kernel_s2d, s2d_block_taps
from npe_tpu_torch.ops.kernels import add_launches, build

SOURCE = "npe_tpu_torch/csrc/rgb_beta_tail.cu"
REPLACES = "npe_tpu/ops/pallas/mdcl_kernels.py:394"
RR = 16  # r*r; the kernels are compiled for r = 4
# What one block may ask for on Hopper (dynamic, after opting in).
SMEM_LIMIT = 227 * 1024


def pack_head_taps(k, r=4):
    """Dense composed MDCL kernel (Cout, Cin, K, K) -> the per-tap matrices
    (9, r*r*Cin, r*r*Cout) of its space-to-depth(r) form, tap t = 3*u + v
    for the packed tap (u, v), both channel axes component-major
    (`pack_kernel_s2d`). Needs the 3x3 cell footprint: K <= 2*r + 1."""
    t = s2d_block_taps(k.shape[-1], r)
    if t != 3:
        raise ValueError(f"a {k.shape[-1]}x{k.shape[-1]} kernel at r={r} packs to {t}x{t} taps, not 3x3")
    kp = pack_kernel_s2d(k, r)  # (rr*Cout, rr*Cin, 3, 3)
    return kp.permute(2, 3, 1, 0).reshape(9, kp.shape[1], kp.shape[0]).contiguous()


def tap_conv(h, taps):
    """sum_t shift_t(h) @ taps[t] over the nine unit offsets with a zero
    border, written as one 3x3 conv. h: (N, in, H, W); taps: (9, in, out)."""
    n_in, n_out = taps.shape[1:]
    return F.conv2d(h, taps.reshape(3, 3, n_in, n_out).permute(3, 2, 0, 1), padding=1)


def sum_dtype(dtype):
    """The dtype in which the plain versions add, for a working dtype: float32
    for bfloat16 (npe_tpu's kernels multiply bf16 operands and add in float32),
    else the dtype itself, so float32 and float64 run as they are."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def rgb_beta_tail_reference(trunk, tg_taps, tb_taps):
    """Plain version. trunk: (N, 6*rr, H, W) component-major pre-activations;
    tg_taps (9, 2rr, 2rr), tb_taps (9, 4rr, 2rr). Returns (N, 3*rr, H, W).

    The working dtype is the taps'. In bfloat16 it rounds where npe_tpu's
    kernel rounds (`_beta_tail_kernel`): the sigmoids of R and G go to bf16
    just before the tap products and stay float32 everywhere else, the sums
    are float32, and the Beta means are rounded to bf16 at the end. The trunk
    is bf16 (the hybrid head's library conv wrote it) or float32 (the fused
    head's, which npe_tpu never rounds). In float32 every cast is the
    identity."""
    mx, acc = tg_taps.dtype, sum_dtype(tg_taps.dtype)
    pre = trunk.to(acc)
    pair = pre.shape[1] // 3  # the (alpha, beta) planes of one colour
    red = torch.sigmoid(pre[:, :pair])
    grn = torch.sigmoid(pre[:, pair : 2 * pair] + tap_conv(red.to(mx).to(acc), tg_taps.to(acc)))
    rg = torch.cat([red, grn], 1).to(mx).to(acc)
    blu = torch.sigmoid(pre[:, 2 * pair :] + tap_conv(rg, tb_taps.to(acc)))
    rr = pair // 2
    return torch.cat([beta_mean(c[:, :rr], c[:, rr:]) for c in (red, grn, blu)], 1).to(mx)


def check_tensors(fn, tensors, shapes, float32=()):
    """The checks every kernel wrapper here makes, and its working dtype:
    the tensors named in `float32` (the affines) are float32, all the others
    share one dtype, float32 or bfloat16, which picks the kernel's form; one
    device, contiguous, 16-byte aligned, and the expected shape. Raises;
    never copies or casts."""
    first = next(iter(tensors.values()))
    working = next(t.dtype for name, t in tensors.items() if name not in float32)
    if working not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn} wants float32 or bfloat16 tensors, got {working}")
    for name, t in tensors.items():
        want = torch.float32 if name in float32 else working
        if t.dtype != want:
            rule = "one dtype for all, float32 or bfloat16" + "".join(f"; {n} float32" for n in float32)
            raise TypeError(f"{fn}: {name} is {t.dtype}, wants {want} ({rule})")
        if t.device != first.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not on {first.device}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, wants {tuple(shapes[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} wants contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn} wants 16-byte aligned tensors; {name} is not")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cpu or cuda tensors, got {first.device}")
    return working


def count_launch(fn, dtype):
    """One more launch of `fn`'s kernel in the form for `dtype`: float32
    launches count in `fn.launches`, bfloat16 ones in `fn.launches_bf16`."""
    add_launches(fn, "launches_bf16" if dtype == torch.bfloat16 else "launches")


def tail_smem_bytes(w, rows=1):
    """What one block of the kernel holds: both tap tensors, and the R and G
    maps of its `rows` cell rows, the two rows either side and one spare,
    each plane with a zero border of one cell. The map's height does not
    count."""
    return (9 * 2 * RR * 2 * RR + 9 * 4 * RR * 2 * RR + 4 * RR * (rows + 5) * (w + 2)) * 4


def tail_rows(batch, h, w, sm_count):
    """Cell rows a block of the kernel computes: the fewest (a divisor of h
    whose maps fit a block) that keep all batch x h / rows blocks in one
    wave, one a multiprocessor (a block holds 138 to 207 KB of shared memory
    at w = 16); past that, the most. A block's time grows with its rows, so
    one image takes 16 blocks of one row, a batch of 16 eight blocks of two
    rows each, a batch of 128 one block of 16 rows (scripts/kernel_sweep.py
    has the times behind this)."""
    fits = [r for r in range(1, h + 1) if h % r == 0 and tail_smem_bytes(w, r) <= SMEM_LIMIT]
    return next((r for r in fits if batch * (h // r) <= sm_count), fits[-1])


def vjp_of_plain(plain, needs_grad, inputs, g):
    """The gradients of plain(*inputs) for the cotangent g, None where
    `needs_grad` is False: the backward of a kernel's autograd.Function."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs_grad)]
        wanted = [t for t, need in zip(ins, needs_grad) if need]
        grads = iter(torch.autograd.grad(plain(*ins), wanted, g))
    return tuple(next(grads) if need else None for need in needs_grad)


@functools.cache
def _entry(bf16):
    lib = build.load("rgb_beta_tail")
    fn = lib.npe_rgb_beta_tail_bf16 if bf16 else lib.npe_rgb_beta_tail
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (5 if bf16 else 4) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(trunk, tg_taps, tb_taps):
    """One launch of the kernel in the taps' form (float32, or bfloat16 over a
    bf16 or a float32 trunk); returns the (N, 48, H, W) output in the taps'
    dtype. Checked by the caller."""
    n, _, h, w = trunk.shape
    bf16 = tg_taps.dtype == torch.bfloat16
    out = torch.empty((n, 3 * RR, h, w), dtype=tg_taps.dtype, device=trunk.device)
    rows = tail_rows(n, h, w, torch.cuda.get_device_properties(trunk.device).multi_processor_count)
    args = [trunk.data_ptr(), tg_taps.data_ptr(), tb_taps.data_ptr(), out.data_ptr(), n, h, w, rows]
    if bf16:
        args.append(int(trunk.dtype == torch.float32))
    with torch.cuda.device(trunk.device):
        rc = _entry(bf16)(*args, torch.cuda.current_stream(trunk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rgb_beta_tail kernel launch failed with CUDA error {rc}")
    return out


class _Tail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, trunk, tg_taps, tb_taps):
        ctx.save_for_backward(trunk, tg_taps, tb_taps)
        out = _launch(trunk, tg_taps, tb_taps)
        count_launch(rgb_beta_tail, tg_taps.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        return vjp_of_plain(rgb_beta_tail_reference, ctx.needs_input_grad, ctx.saved_tensors, g)


def _check(fn, trunk, tg_taps, tb_taps, float32=()):
    if trunk.ndim != 4 or trunk.shape[0] < 1 or trunk.shape[2] % 2:
        raise ValueError(f"{fn} wants a (N, {6 * RR}, H, W) trunk with H even, got {tuple(trunk.shape)}")
    n, _, h, w = trunk.shape
    dtype = check_tensors(
        fn,
        {"tg_taps": tg_taps, "tb_taps": tb_taps, "trunk": trunk},
        {"trunk": (n, 6 * RR, h, w), "tg_taps": (9, 2 * RR, 2 * RR), "tb_taps": (9, 4 * RR, 2 * RR)},
        float32,
    )
    if tail_smem_bytes(w) > SMEM_LIMIT:
        raise ValueError(f"{fn}: a map {w} cells wide needs {tail_smem_bytes(w)} B of shared memory a block")
    return dtype


def rgb_beta_tail(trunk, tg_taps, tb_taps):
    """Fused autoregressive RGB-Beta tail. trunk: (N, 96, H, W) component-major
    trunk pre-activations (see the module docstring), H even; tg_taps (9, 32,
    32), tb_taps (9, 64, 32) from `pack_head_taps`; all float32 (the float32
    form) or all bfloat16 (the bf16 form, which rounds where npe_tpu's kernel
    does: `rgb_beta_tail_reference`). Returns the (N, 48, H, W)
    component-major Beta means in that dtype."""
    _check("rgb_beta_tail", trunk, tg_taps, tb_taps)
    if trunk.device.type == "cpu":
        return rgb_beta_tail_reference(trunk, tg_taps, tb_taps)
    return _Tail.apply(trunk, tg_taps, tb_taps)


def tail_only(trunk, tg_taps, tb_taps):
    """The kernel's bf16 form over a float32 trunk, as the fused head's last
    launch runs it under bfloat16 (npe_tpu never rounds that trunk): bf16
    taps, bf16 output. For checking and timing it on the card; not a path of
    the models, not counted in the launches. Its plain version is
    `rgb_beta_tail_reference` on the same tensors."""
    if tg_taps.dtype != torch.bfloat16:
        raise TypeError(f"tail_only runs the bf16 form over a float32 trunk; the taps are {tg_taps.dtype}")
    _check("tail_only", trunk, tg_taps, tb_taps, float32=("trunk",))
    if trunk.device.type != "cuda":
        raise ValueError("tail_only launches the kernel: it wants CUDA tensors")
    return _launch(trunk, tg_taps, tb_taps)


rgb_beta_tail.launches = 0
rgb_beta_tail.launches_bf16 = 0
