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
them. It has a float32 and a bfloat16 form, picked by the dtype of the
tensors it is given (`check_tensors`; the bf16 form rounds where npe_tpu's
kernel rounds under bf16); `rgb_beta_tail.launches` counts the float32
form's launches, `rgb_beta_tail.launches_bf16` the bf16 form's.

The backward (npe_tpu's custom VJP, `_tail_bwd`: the VJP of its plain
version) is hand-written too, in both forms (`npe_rgb_beta_tail_bwd[_bf16]`,
device code in `rgb_beta_tail.cuh`): passes over the forward's row groups
that leave u_B, u_G and the recomputed maps in a float32 scratch, and, only
where autograd asks for the taps' gradients, per-block partial sums of dtg
and dtb added in a fixed order. `rgb_beta_tail_backward_reference` is its
plain version; `rgb_beta_tail.launches_bwd` and `.launches_bwd_bf16` count
its calls.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from npe_tpu_torch.ops.beta import beta_mean
from npe_tpu_torch.ops.conv import pack_kernel_s2d, s2d_block_taps
from npe_tpu_torch.ops.kernels import add_launches, build, current_tally

SOURCE = "npe_tpu_torch/csrc/rgb_beta_tail.cu"
REPLACES = "npe_tpu/ops/pallas/mdcl_kernels.py:394"
REPLACES_BWD = "npe_tpu/ops/pallas/mdcl_kernels.py:430"  # `_tail_bwd`, the custom VJP's backward
RR = 16  # r*r; the kernels are compiled for r = 4
SCRATCH_PLANES = 12 * RR  # the backward's float32 planes an image: [R, G] rounded, G, u_B, u_G, dr_B
TAP_GRADS = 9 * 4 * RR * 2 * RR + 9 * 2 * RR * 2 * RR  # dtb then dtg, the partial sums a block
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


def tap_conv_transposed(u, taps):
    """The adjoint of `tap_conv`: sum_t shift_-t(u) @ taps[t]^T, written as
    `tap_conv` over the mirrored taps (tap 8 - t) transposed. u: (N, out, H,
    W); taps: (9, in, out); returns (N, in, H, W)."""
    return tap_conv(u, taps.flip(0).transpose(1, 2))


def tap_grad(h, u):
    """The taps' gradient of `tap_conv(h, taps)` for the cotangent u:
    sum over the cells of shift_t(h)^T u, (9, in, out)."""
    hh, ww = u.shape[2:]
    hp = F.pad(h, (1, 1, 1, 1))
    return torch.stack([torch.einsum("nihw,nohw->io", hp[:, :, dy:dy + hh, dx:dx + ww], u)
                        for dy in range(3) for dx in range(3)])


def beta_mean_vjp(a, b, g):
    """(d alpha, d beta) of `beta_mean(a, b)` for the cotangent g, in the
    order torch's autograd forms them."""
    g2 = 2.0 * g
    s = a + b + 1e-8
    gs = -g2 * a / (s * s)
    return g2 / s + gs, gs


def sigmoid_vjp(y, g):
    """The cotangent of sigmoid's input from its output y and g, as torch's."""
    return g * (1 - y) * y


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


def rgb_beta_tail_backward_reference(g, trunk, tg_taps, tb_taps, needs=(True, True, True)):
    """Plain version of exactly what the backward kernels compute: the
    gradients of `rgb_beta_tail_reference(trunk, tg_taps, tb_taps)` for the
    cotangent g of its output, written out, not through autograd, with None
    where `needs` (trunk, tg, tb) is False. Per cell, with R, G, B the
    forward's sigmoids and dbeta the Beta mean's derivative:

        u_B = dbeta(B) g_B * B(1 - B),  (dr_B, dg_B) = B^T(u_B)
        u_G = (dbeta(G) g_G + dg_B) * G(1 - G)
        dT  = [(dbeta(R) g_R + dr_B + G^T(u_G)) * R(1 - R), u_G, u_B]
        dtb = sum over cells of shift_t([R, G])^T u_B,  dtg = shift_t(R)^T u_G

    In bfloat16 it rounds where the bf16 VJP of `rgb_beta_tail_reference`
    rounds: the products read R and [R, G] as bf16 (the forward's points);
    B^T's and G^T's sums, the cotangents of those rounded inputs, go to bf16;
    dtg and dtb are float32 sums, then bf16; dT is rounded to the trunk's
    dtype. The rest is float32. In float32 every cast is the identity."""
    mx, acc = tg_taps.dtype, sum_dtype(tg_taps.dtype)

    def rnd(v):
        return v.to(mx).to(acc)

    pre, g, tg, tb = trunk.to(acc), g.to(acc), tg_taps.to(acc), tb_taps.to(acc)
    pair = pre.shape[1] // 3
    rr = pair // 2
    red = torch.sigmoid(pre[:, :pair])
    r_in = rnd(red)
    grn = torch.sigmoid(pre[:, pair:2 * pair] + tap_conv(r_in, tg))
    rg = rnd(torch.cat([red, grn], 1))
    blu = torch.sigmoid(pre[:, 2 * pair:] + tap_conv(rg, tb))

    def colour(c, k):  # the Beta mean's cotangent, back to colour k's (alpha, beta) planes
        return torch.cat(beta_mean_vjp(c[:, :rr], c[:, rr:], g[:, k * rr:(k + 1) * rr]), 1)

    u_b = sigmoid_vjp(blu, colour(blu, 2))
    d_rg = rnd(tap_conv_transposed(u_b, tb))
    u_g = sigmoid_vjp(grn, colour(grn, 1) + d_rg[:, pair:])
    d_red = colour(red, 0) + d_rg[:, :pair] + rnd(tap_conv_transposed(u_g, tg))
    d_trunk = torch.cat([sigmoid_vjp(red, d_red), u_g, u_b], 1).to(trunk.dtype)
    return (d_trunk if needs[0] else None, tap_grad(r_in, u_g).to(mx) if needs[1] else None,
            tap_grad(rg, u_b).to(mx) if needs[2] else None)


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


def tail_bwd_smem_bytes(w, rows):
    """What one block of the backward's largest pass holds: the B product's
    taps (rows padded by 4 floats) and its 4rr-plane input map on the rows
    +-1 with a zero border, or the taps' pass's map and the 4rr planes of
    u_B and u_G on its own rows. Below `tail_smem_bytes` wherever the forward
    fits (tests/test_torch_rgb_beta_backward.py)."""
    plane = (rows + 2) * (w + 2)
    return max(9 * 4 * RR * (2 * RR + 4) + 4 * RR * plane, (4 * RR + 4) * (plane + rows * w)) * 4


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


@functools.cache
def _bwd_entry(bf16):
    lib = build.load("rgb_beta_tail")
    fn = lib.npe_rgb_beta_tail_bwd_bf16 if bf16 else lib.npe_rgb_beta_tail_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * (7 if bf16 else 6) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(g, trunk, tg_taps, tb_taps, need_trunk=True, need_taps=True):
    """One call of the backward kernels in the taps' form (float32, or
    bfloat16 over a bf16 or a float32 trunk) for the cotangent g (the
    output's shape and dtype, contiguous): (dtrunk in the trunk's dtype,
    dtg, dtb), None where not asked for (`need_taps` gives both). Scratch:
    the passes' float32 planes and, for the taps, the blocks' partial sums.
    Checked by the caller; not counted."""
    n, _, h, w = trunk.shape
    bf16 = tg_taps.dtype == torch.bfloat16
    rows = tail_rows(n, h, w, torch.cuda.get_device_properties(trunk.device).multi_processor_count)
    scratch = torch.empty((n, SCRATCH_PLANES, h, w), dtype=torch.float32, device=trunk.device)
    dtrunk = torch.empty_like(trunk)
    partial = dtg = dtb = None
    if need_taps:
        partial = torch.empty((n * (h // rows), TAP_GRADS), dtype=torch.float32, device=trunk.device)
        dtg, dtb = torch.empty_like(tg_taps), torch.empty_like(tb_taps)
    args = [g, trunk, tg_taps, tb_taps, scratch, partial, dtrunk, dtg, dtb]
    args = [None if t is None else t.data_ptr() for t in args] + [n, h, w, rows, int(need_trunk), int(need_taps)]
    if bf16:
        args.append(int(trunk.dtype == torch.float32))
    with torch.cuda.device(trunk.device):
        rc = _bwd_entry(bf16)(*args, torch.cuda.current_stream(trunk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rgb_beta_tail backward kernel launch failed with CUDA error {rc}")
    return dtrunk if need_trunk else None, dtg, dtb


class _Tail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, trunk, tg_taps, tb_taps):
        ctx.save_for_backward(trunk, tg_taps, tb_taps)
        out = _launch(trunk, tg_taps, tb_taps)
        count_launch(rgb_beta_tail, tg_taps.dtype)
        # autograd may run the backward on a thread of its own: it counts where the forward did
        ctx.tally = current_tally()
        return out

    @staticmethod
    def backward(ctx, g):
        trunk, tg_taps, tb_taps = ctx.saved_tensors
        need_trunk, need_tg, need_tb = ctx.needs_input_grad
        dtrunk, dtg, dtb = _launch_bwd(g.to(tg_taps.dtype).contiguous(), trunk, tg_taps, tb_taps, need_trunk,
                                       need_tg or need_tb)
        add_launches(rgb_beta_tail, "launches_bwd_bf16" if tg_taps.dtype == torch.bfloat16 else "launches_bwd",
                     tally=ctx.tally)
        return dtrunk, dtg if need_tg else None, dtb if need_tb else None


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
    component-major Beta means in that dtype. The inputs that need a
    gradient get one from the backward kernels, only those
    (`rgb_beta_tail_backward_reference` is their plain version)."""
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
rgb_beta_tail.launches_bwd = 0
rgb_beta_tail.launches_bwd_bf16 = 0
