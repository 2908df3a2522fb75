"""The MDBLOCK's x-gradient (the backward kernels of `mdblock_fused`) on the
CPU: its plain version `mdblock_backward_reference` against torch's VJP of
the plain forward and against npe_tpu's `mdblock_fused` VJP, the transposed
MDCL it rests on, the slopes at exactly zero, the bf16 rounding points, the
backward kernels' plan (`bwd_plan`) and an emulation of the float32 kernel's
arithmetic, and the autograd wiring of `_MDBlock` with the plain versions
standing in for the launches (the kernels themselves run only on the card:
chip_smoke.py phases 3 and 3b, tests/test_torch_cuda.py).

Tolerances: float64 to 1e-7 of the largest value (the same sums in another
order); float32 against npe_tpu at tests/test_torch_mdblock.py's GRAD (rtol
1e-3 / atol 1e-4); bf16 in bf16 steps (2^-8) of |want| + std, as
chip_smoke.py's `within_steps`."""

import gc
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parity as tp
from npe_tpu.ops.pallas import mdcl_kernels as jk
from npe_tpu_torch.models import common as tcommon
from npe_tpu_torch.ops.kernels import mdblock as tk
from npe_tpu_torch.ops.kernels import tallying
from npe_tpu_torch.utils.checkpoints import from_reference
from test_torch_mdblock import GRAD, _block, _jax_kernel_inputs, _port_kernel_inputs

tp.torch_threads()

SCALES = [(0, 2), (0, 2, 3), (2, 3, 4)]
BF16 = torch.bfloat16
# bf16 steps of |want| + std between the backward reference and the bf16
# VJP, chip_smoke.py's rule for a bf16 gradient (BF16_POINTS + 1): three
# rounding points (each MDCL^T's sum and dx) and one more for a gradient. The
# reference's operand pairs (`bf16_pair`) hold g_r and g_m1 to about 16 bits
# and add no step of their own.
BF16_BACKWARD_STEPS = 4


def _inputs(c, scales, size, seed, batch=2, dtype=torch.float64):
    """x, taps1, taps2, affines (as chip_smoke.py's `mdblock_inputs`: O(1)
    features, taps at unit gain, non-trivial affines) and a cotangent g;
    the affines float32 unless dtype is float64."""
    rng = np.random.RandomState(seed)
    n_taps = 9 * len(tk.dilations(scales))
    x = rng.randn(batch, c, size, size)
    taps = [rng.randn(n_taps, c, c) / np.sqrt(2.2 * c) for _ in range(2)]
    aff = np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3)
    g = rng.randn(batch, c, size, size)
    work = torch.float32 if dtype == torch.float64 else dtype
    x, t1, t2, g = (torch.from_numpy(a).to(work).to(dtype) if dtype != torch.float64 else torch.from_numpy(a)
                    for a in (x, *taps, g))
    return x, t1, t2, torch.from_numpy(aff).to(torch.float64 if dtype == torch.float64 else torch.float32), g


def _vjp(x, t1, t2, aff, g, scales):
    xg = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(tk.mdblock_taps_reference(xg, t1, t2, aff, scales), xg, g)
    return dx


def _reference(x, t1, t2, aff, g, scales):
    y, h1 = tk.mdblock_forward_parts(x, t1, t2, aff, scales)
    return tk.mdblock_backward_reference(g, x, y, h1, t1, t2, aff, scales)


def _size(scales):
    return 8 if max(scales) <= 2 else 16


@pytest.mark.parametrize("scales", SCALES)
def test_the_backward_reference_is_the_vjp_of_the_plain_version_in_float64(scales):
    x, t1, t2, aff, g = _inputs(16, scales, _size(scales), seed=1)
    want = _vjp(x, t1, t2, aff, g, scales)
    got = _reference(x, t1, t2, aff, g, scales)
    assert float(want.abs().max()) > 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-7, atol=1e-7 * float(want.abs().max()))


@pytest.mark.parametrize("scales", SCALES)
def test_the_backward_reference_is_the_vjp_of_the_plain_version_in_float32(scales):
    """The slopes come from the same forward's y and h1, so float32 differs
    from the VJP only by the order of the sums."""
    x, t1, t2, aff, g = _inputs(16, scales, _size(scales), seed=2, dtype=torch.float32)
    want = _vjp(x, t1, t2, aff, g, scales)
    got = _reference(x, t1, t2, aff, g, scales)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def _npe_tpu_fused_x_grad(x_nhwc, v, scales, g_nhwc, dtype):
    """jax.vjp of npe_tpu's `mdblock_fused` (its Pallas kernel in interpret
    mode forward, `_fused_bwd` backward) for x's cotangent g."""
    jt1, jt2, jaff = _jax_kernel_inputs(v, scales)
    jt1, jt2 = jt1.astype(dtype), jt2.astype(dtype)
    jaff = tuple(a.astype(dtype) for a in jaff)
    offs = jk.tap_offsets(list(scales))
    _, vjp = jax.vjp(lambda x: jk.mdblock_fused(x, jt1, jt2, jaff, offs, 4, True), jnp.asarray(x_nhwc, dtype))
    return np.asarray(vjp(jnp.asarray(g_nhwc, dtype))[0])


@pytest.mark.parametrize("scales", SCALES)
def test_the_x_gradient_matches_npe_tpus_fused_vjp(scales):
    size = _size(scales)
    v, x = _block(16, scales, size, seed=3)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    t1, t2, aff = _port_kernel_inputs(from_reference(v, "cpu"), scales)
    want = _npe_tpu_fused_x_grad(x, v, scales, g, jnp.float32)
    got = _reference(tp.nchw(x), t1, t2, aff, tp.nchw(g), scales)
    assert np.abs(want).max() > 0.5
    tp.assert_close(tp.nhwc(got), want, **GRAD)


@pytest.mark.parametrize("scales", SCALES)
def test_the_x_gradient_matches_npe_tpus_fused_vjp_in_float64(scales):
    """float64 inputs under x64: npe_tpu's reference (its `_fused_bwd`)
    still works in float32 inside (`mdcl_kernels.py:110-115` cast x, the taps
    and each MDCL input to float32), the port's in float64, so they agree to
    float32's sums, 1e-5 of the largest value."""
    size = _size(scales)
    v, x = _block(16, scales, size, seed=5)
    g = np.random.RandomState(6).randn(*x.shape)
    v64 = {k: a.astype(np.float64) for k, a in v.items()}
    with tp.x64():
        want = _npe_tpu_fused_x_grad(x.astype(np.float64), v64, scales, g, jnp.float64)
    assert want.dtype == np.float64
    tv = {k: t.double() for k, t in from_reference(v64, "cpu").items()}
    t1, t2, aff = _port_kernel_inputs(tv, scales)
    got = _reference(tp.nchw(x.astype(np.float64)), t1, t2, aff, tp.nchw(g), scales)
    np.testing.assert_allclose(tp.nhwc(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("scales", SCALES)
def test_the_transposed_mdcl_is_the_adjoint_over_the_mirrored_taps(scales):
    """<MDCL(h), g> = <h, MDCL^T(g)> in float64, with Cin != Cout so that a
    transposition mix-up cannot pass; the mirror map names each tap's
    opposite offset and is its own inverse."""
    offs = tk.tap_offsets(scales)
    mirror = tk.tap_mirror(len(offs))
    assert [offs[m] for m in mirror] == [(-dy, -dx) for dy, dx in offs]
    assert [mirror[m] for m in mirror] == list(range(len(offs)))
    rng = np.random.RandomState(7)
    size = _size(scales)
    h = torch.from_numpy(rng.randn(2, 8, size, size))
    g = torch.from_numpy(rng.randn(2, 6, size, size))
    taps = torch.from_numpy(rng.randn(len(offs), 8, 6))
    fwd = tk._mdcl_taps(h, taps, offs)
    back = tk.mdcl_transposed(g, taps, offs)
    assert fwd.shape == g.shape and back.shape == h.shape
    lhs, rhs = float((fwd * g).sum()), float((h * back).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs) and abs(lhs) > 1.0


def test_the_slopes_at_exactly_zero_are_torchs():
    """x = 0 and t0 = t1 = t2 = 0 put every pre-activation at exactly 0
    (h0 = 0, so MDCL1's sum and a1 are 0, so h1 and MDCL2's sum are 0, so
    a2 = 0), with every tap nonzero: the slopes read from the signs of y and
    h1 are torch's 0.2 at 0, and dx is 0.2 s2 g + s0 0.2 MDCL1^T(s1 0.2
    MDCL2^T(0.2 s2 g)), torch's VJP. npe_tpu's lrelu, jnp.where(x >= 0),
    takes slope 1 at 0: its VJP is the same form with slope 1."""
    scales = (0, 2)
    offs = tk.tap_offsets(scales)
    x, t1, t2, aff, g = _inputs(16, scales, 8, seed=8)
    x = torch.zeros_like(x)
    aff[1::2] = 0.0  # t0, t1, t2
    s0, _, s1, _, s2, _ = (a[None, :, None, None] for a in aff)
    y, h1 = tk.mdblock_forward_parts(x, t1, t2, aff, scales)
    assert not y.any() and not h1.any()

    def closed_form(slope):
        inner = tk.mdcl_transposed(slope * s2 * g, t2, offs) * slope * s1
        return slope * s2 * g + s0 * slope * tk.mdcl_transposed(inner, t1, offs)

    got = tk.mdblock_backward_reference(g, x, y, h1, t1, t2, aff, scales)
    for want in (_vjp(x, t1, t2, aff, g, scales), closed_form(0.2)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    with tp.x64():
        jt1, jt2 = (jnp.asarray(t.numpy()) for t in (t1, t2))
        jaff = tuple(jnp.asarray(a.numpy()) for a in aff)
        _, vjp = jax.vjp(lambda x: jk.mdblock_taps_reference(x, jt1, jt2, jaff, jk.tap_offsets(list(scales))),
                         jnp.asarray(tp.nhwc(x)))
        jax_dx = np.asarray(vjp(jnp.asarray(tp.nhwc(g)))[0])
    # npe_tpu's reference works in float32 inside (mdcl_kernels.py:110-115)
    np.testing.assert_allclose(jax_dx, tp.nhwc(closed_form(1.0)), rtol=1e-5, atol=1e-5 * np.abs(jax_dx).max())
    assert np.abs(jax_dx - tp.nhwc(got)).max() > 0.1 * np.abs(jax_dx).max()  # the two conventions really part


@pytest.mark.parametrize("scales", SCALES)
def test_the_bf16_vjp_rounds_where_the_reference_says(scales):
    """torch's VJP of the bf16 plain version rounds each MDCL^T's sum (the
    cotangent of the rounded MDCL input) to bf16 and dx once at the end, and
    keeps the rest float32: the same formula written out (the reference
    without its two operand pairs) gives it up to the order of the float32
    sums, one bf16 step at most where a sum lies at a rounding boundary."""
    x, t1, t2, aff, g = _inputs(32, scales, _size(scales), seed=9, dtype=BF16)
    offs = tk.tap_offsets(scales)
    y, h1 = tk.mdblock_forward_parts(x, t1, t2, aff, scales)
    s0, t0, s1, _, s2, _ = (a[None, :, None, None] for a in aff)
    f = torch.float32

    def rnd(v):
        return v.to(BF16).to(f)

    gr = tk._slope(y.to(f), g.to(f)) * s2
    gm1 = tk._slope(h1.to(f), rnd(tk.mdcl_transposed(gr, t2.to(f), offs))) * s1
    want = (gr + tk._slope(x.to(f) * s0 + t0, rnd(tk.mdcl_transposed(gm1, t1.to(f), offs))) * s0).to(BF16)
    got = _vjp(x, t1, t2, aff, g, scales)
    assert got.dtype == BF16
    _within_bf16_steps(got, want, 1)


@pytest.mark.parametrize("scales", SCALES)
def test_the_bf16_backward_reference_is_within_its_stated_steps_of_the_bf16_vjp(scales):
    x, t1, t2, aff, g = _inputs(32, scales, _size(scales), seed=10, dtype=BF16)
    got = _reference(x, t1, t2, aff, g, scales)
    want = _vjp(x, t1, t2, aff, g, scales)
    assert got.dtype == want.dtype == BF16
    _within_bf16_steps(got, want, BF16_BACKWARD_STEPS)


def test_the_bf16_operand_pair_holds_float32_to_16_bits():
    """`bf16_pair`, the bf16 backward's operands for the float32 g_r and
    g_m1: hi + lo is within 2^-16 of v relative (one bf16 alone is up to
    2^-8 off, and more than 2^-16 off on most values), hi is v rounded to
    bf16, and lo is a bf16 value."""
    v = torch.from_numpy(np.random.RandomState(15).randn(4096).astype(np.float32)) * 10.0
    pair = tk.bf16_pair(v)
    hi = v.to(BF16).float()
    lo = pair - hi
    assert torch.equal(lo.to(BF16).float(), lo)
    assert float(((pair - v).abs() / v.abs()).max()) <= 2.0 ** -16
    assert float(((hi - v).abs() / v.abs() > 2.0 ** -16).float().mean()) > 0.9
    assert torch.equal(tk.bf16_pair(hi), hi)  # a bf16 value is its own pair, lo = 0


def _within_bf16_steps(got, want, steps):
    """Every element within `steps` bf16 steps (2^-8) of |want| + std(want);
    returns the worst fraction of that limit."""
    g, w = got.double(), want.double()
    limit = steps * 2.0 ** -8 * (w.abs() + w.std())
    worst = float(((g - w).abs() / limit).max())
    assert worst <= 1.0, worst
    return worst


# --- the backward kernels' plan and float32 arithmetic (csrc/mdblock_bwd.cu)

FULL_IAN = [(512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3))]  # chip_smoke.py's MDBLOCK_SHAPES
H100_SMS = 132


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("channels,size,scales", FULL_IAN)
def test_the_backward_plan_at_full_ians_shapes(channels, size, scales, batch, dtype):
    """`bwd_plan` on the H100: its shared memory fits a block and is what
    the kernel asks for; the slices partition the units with at least
    BWD_MIN_UNITS each; a cluster holds at most the portable 8 blocks and
    divides the slices; the blocks run at once (one an SM, no more clusters
    than the card holds); at one image they fill most of the SMs and at most
    three groups of slices take the second sum launch, and the cut is the
    cheapest by the plan's cost; two patches a block only in bf16, without
    slices; one slice from the batch that fills the card."""
    plan = tk.bwd_plan(batch, channels, size, size, scales, dtype, H100_SMS)
    bf16 = dtype == BF16
    radius = max(tk.dilations(scales))
    assert plan.smem == tk.bwd_smem_bytes(bf16, plan.sub_tiles, plan.stages, plan.halo_buffers, radius,
                                          plan.tile_channels)
    assert plan.smem <= tk.SMEM_PER_BLOCK
    fewest, most = tk.BWD_STAGES[bf16]
    assert fewest <= plan.stages <= most and plan.halo_buffers in ((1, 2) if bf16 else (2,))
    units = channels * (2 if bf16 else 4) // tk.BWD_CHUNK_BYTES * 9 * len(tk.dilations(scales))
    bounds = [s * units // plan.splits for s in range(plan.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == units
    assert min(b - a for a, b in zip(bounds, bounds[1:])) >= tk.BWD_MIN_UNITS
    assert 1 <= plan.cluster <= tk.MAX_CLUSTER == 8 and plan.splits % plan.cluster == 0
    tiles = batch * (size // 8) ** 2 // plan.sub_tiles * channels // plan.tile_channels
    if plan.splits > 1:
        assert tiles * plan.splits <= H100_SMS
        assert tiles * plan.splits // plan.cluster <= tk.CLUSTER_SLOTS[plan.cluster]
    if batch == 1:
        assert tiles * plan.splits > H100_SMS // 2 and plan.splits // plan.cluster <= 3
        cost = -(-units // plan.splits) + tk.BWD_GROUP_COST * (plan.splits // plan.cluster - 1)
        for splits, cluster in ((plan.splits, 1), (plan.splits // 2, plan.cluster), (2 * plan.splits, plan.cluster)):
            if splits >= 1 and splits % cluster == 0 and tiles * splits // cluster <= tk.CLUSTER_SLOTS[cluster] \
                    and tiles * splits <= H100_SMS:
                assert cost <= -(-units // splits) + tk.BWD_GROUP_COST * (splits // cluster - 1)
    assert plan.sub_tiles == 1 or (bf16 and plan.splits == 1)
    assert plan.tile_channels == (256 if plan.sub_tiles == 2 and channels >= 256 else 128)
    if batch == 128:
        assert plan.splits == 1 and plan.sub_tiles == (2 if bf16 else 1)


def _sum_in_order(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _emulated_float32_backward(g, x, y, h1, taps1, taps2, aff, scales, plan, products=3):
    """The float32 backward kernel's arithmetic in float32 on the CPU: g_r
    and g_m1 as TF32 (hi, lo) pairs (`tf32_split`), each MDCL^T unit (a
    chunk of 32 input channels co by one tap) a stage of lo*hi + hi*lo +
    hi*hi of the pairs' shifted windows and the split mirrored tap (or hi*hi
    alone, `products=1`), summed from zero and added to float32 running sums;
    each slice of the plan's units its own sum; the slices added in cluster
    order, then the clusters in order. (A product of two TF32 values is exact
    in float32; the tensor cores' truncation is what the per-stage sums keep
    from growing.)"""
    n, c, hh, ww = x.shape
    offs = tk.tap_offsets(scales)
    mirror = tk.tap_mirror(len(offs))
    r = max(tk.dilations(scales))
    chunk = tk.BWD_CHUNK_BYTES // 4
    units = [(ch, t) for ch in range(-(-c // chunk)) for t in range(len(offs))]
    s0, t0, s1, _, s2, _ = (a[None, :, None, None] for a in aff)

    def mdcl_t(v, taps):
        hi, lo = (F.pad(a, (r, r, r, r)) for a in tk.tf32_split(v))

        def window(a, t, cs):  # (n, pixels, k)
            dy, dx = offs[t]
            return a[:, cs, r + dy:r + dy + hh, r + dx:r + dx + ww].flatten(2).transpose(1, 2)

        slices = []
        for s in range(plan.splits):
            acc = torch.zeros(n, hh * ww, c)
            for ch, t in units[s * len(units) // plan.splits:(s + 1) * len(units) // plan.splits]:
                cs = slice(ch * chunk, (ch + 1) * chunk)
                b_hi, b_lo = tk.tf32_split(taps[mirror[t]][:, cs].t().contiguous())  # (co, ci)
                a_hi, a_lo = window(hi, t, cs), window(lo, t, cs)
                step = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi if products == 3 else a_hi @ b_hi
                acc = acc + step
            slices.append(acc)
        clusters = [_sum_in_order(slices[i:i + plan.cluster]) for i in range(0, plan.splits, plan.cluster)]
        return _sum_in_order(clusters).transpose(1, 2).reshape(n, c, hh, ww)

    gr = tk._slope(y, g) * s2
    gm1 = tk._slope(h1, mdcl_t(gr, taps2)) * s1
    return gr + tk._slope(x * s0 + t0, mdcl_t(gm1, taps1)) * s0


@pytest.mark.parametrize("channels,size,scales", FULL_IAN)
def test_the_float32_backward_arithmetic_keeps_float32_accuracy_and_one_product_does_not(channels, size, scales):
    """Why the float32 backward takes three TF32 products per multiply-add
    from its pixel-major (hi, lo) pairs: full IAN's blocks at one image, the
    plan's slices and clusters, chip_smoke.py's inputs; the emulated kernel
    (`_emulated_float32_backward`) against the float64 VJP on the same slopes
    (y and h1 of the float64 forward) stays within MDBLOCK_BWD_TOL of the
    largest value, the float32 rule the card holds the kernels to; hi*hi
    alone does not."""
    from chip_smoke import MDBLOCK_BWD_TOL, mdblock_inputs

    x, t1, t2, aff = (a.double() for a in mdblock_inputs(1, channels, size, scales, 41, "cpu"))
    g = torch.from_numpy(np.random.RandomState(42).randn(*x.shape))
    want = _vjp(x, t1, t2, aff, g, scales)
    y, h1 = tk.mdblock_forward_parts(x, t1, t2, aff, scales)
    plan = tk.bwd_plan(1, channels, size, size, scales, torch.float32, H100_SMS)
    assert plan.splits > 1 and plan.cluster > 1
    f32 = [a.float() for a in (g, x, y, h1, t1, t2, aff)]
    tol = MDBLOCK_BWD_TOL * float(want.abs().max())
    three = _emulated_float32_backward(*f32, scales, plan)
    one = _emulated_float32_backward(*f32, scales, plan, products=1)
    err3, err1 = (float((a.double() - want).abs().max()) for a in (three, one))
    assert float(want.std()) > 1
    assert err3 <= tol / 4, (err3, tol)
    assert err1 > tol, (err1, tol)


# --- the wrapper's autograd wiring, the plain versions standing in for the launches


def _fake_forward(x, taps1, taps2, affines, scales, keep_h1=True):
    """What `_launch_float32` / `_launch_bf16` return, from the plain
    version: the output, h1 in the form's scratch layout (bf16:
    pixel-major; float32 NCHW, or None without `keep_h1`), return code 0."""
    y, h1 = tk.mdblock_forward_parts(x, taps1, taps2, affines, scales)
    if x.dtype == BF16:
        return y, h1.permute(0, 2, 3, 1).contiguous(), 0
    return y, h1 if keep_h1 else None, 0


def _fake_backward(g, x, y, h1, taps1, taps2, affines, scales):
    """What `_launch_bwd` returns, from the plain version."""
    h1 = h1.permute(0, 3, 1, 2) if x.dtype == BF16 else h1
    return tk.mdblock_backward_reference(g, x, y, h1, taps1, taps2, affines, scales), 0


@pytest.fixture
def plain_launches(monkeypatch):
    for name in ("_launch_float32", "_launch_bf16"):
        monkeypatch.setattr(tk, name, _fake_forward)
    monkeypatch.setattr(tk, "_launch_bwd", _fake_backward)


def test_the_forward_keeps_h1_and_y_only_when_x_will_need_a_gradient(plain_launches, monkeypatch):
    """With grad on and x requiring it the forward keeps h1 and y; under
    no_grad and inference_mode no node is made, and the h1 the forward made is
    gone once the call returns; with only the taps requiring a gradient,
    neither is kept, and the float32 launch is told not to write h1."""
    x, t1, t2, aff, _ = _inputs(16, (0, 2), 8, seed=11, dtype=torch.float32)
    made, asked = [], []

    def forward(*args):
        y, h1, rc = _fake_forward(*args)
        asked.append(args[5])
        made.append(weakref.ref(h1) if h1 is not None else None)
        return y, h1, rc

    monkeypatch.setattr(tk, "_launch_float32", forward)
    xg = x.clone().requires_grad_(True)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            out = tk._MDBlock.apply(xg, t1, t2, aff, (0, 2))
        gc.collect()
        assert out.grad_fn is None and made[-1]() is None, mode
    out = tk._MDBlock.apply(xg, t1, t2, aff, (0, 2))
    y, h1 = tk.mdblock_forward_parts(x, t1, t2, aff, (0, 2))
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and torch.equal(saved[4], h1) and torch.equal(saved[5], y)
    assert made[-1]() is not None
    t1g = t1.clone().requires_grad_(True)
    out = tk._MDBlock.apply(x, t1g, t2, aff, (0, 2))
    assert len(out.grad_fn.saved_tensors) == 4  # the taps' gradient alone: no h1, no y
    assert asked == [True, True, True, False] and made[-1] is None


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_x_gets_the_backward_and_the_taps_the_plain_vjp(plain_launches, dtype):
    """Through `_MDBlock`: x's gradient is the backward (counted in
    `launches_bwd` / `launches_bwd_bf16`, one a backward), the taps' and
    affines' the plain version's VJP with x's flag off; each asked for
    alone gets only its own."""
    scales = (0, 2, 3)
    x, t1, t2, aff, g = _inputs(16, scales, 16, seed=12, dtype=dtype)
    attr = "launches_bwd_bf16" if dtype == BF16 else "launches_bwd"
    leaves = [t.clone().requires_grad_(True) for t in (x, t1, t2, aff)]
    before = getattr(tk.mdblock_fused, attr)
    got = torch.autograd.grad(tk._MDBlock.apply(*leaves, scales), leaves, g)
    assert getattr(tk.mdblock_fused, attr) == before + 1
    want = torch.autograd.grad(tk.mdblock_taps_reference(*leaves, scales), leaves, g)
    assert torch.equal(got[0], _reference(x, t1, t2, aff, g, scales))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    (only_taps,) = torch.autograd.grad(tk._MDBlock.apply(x, leaves[1], t2, aff, scales), leaves[1], g)
    assert torch.equal(only_taps, want[1]) and getattr(tk.mdblock_fused, attr) == before + 1


def test_a_backward_on_another_thread_counts_in_its_forwards_tally(plain_launches):
    """autograd may run a CUDA backward on a thread of its own: its launch
    counts in the tally of the thread that ran the forward (a capture takes
    back what its own thread counted), not in that other thread's."""
    x, t1, t2, aff, g = _inputs(16, (0, 2), 8, seed=13, dtype=torch.float32)
    xg = x.clone().requires_grad_(True)
    with tallying() as tally:
        out = tk._MDBlock.apply(xg, t1, t2, aff, (0, 2))
        other = {}

        def backward():
            with tallying() as own:
                torch.autograd.grad(out, xg, g)
            other.update(own)

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
    assert tally == {(tk.mdblock_fused, "launches"): 1, (tk.mdblock_fused, "launches_bwd"): 1}
    assert other == {}


def test_the_api_gradients_through_the_backward_wiring_match_npe_tpu(plain_launches, monkeypatch):
    """The slice as a whole: the tiny full IAN's `imgrad` and `imgradRGB`
    (api.IAN, `mdblock_mode="fused"`) with its three MDBLOCKs routed through
    `_MDBlock` (the launches' plain versions) against npe_tpu's on the same
    variables: three backwards a gradient call, three forwards a decode."""
    from npe_tpu.api import IAN as JaxIAN
    from npe_tpu_torch.api import IAN

    def routed(x, taps1, taps2, affines, scales):
        return tk._MDBlock.apply(x, taps1, taps2, affines, tuple(scales))

    monkeypatch.setattr(tcommon, "mdblock_fused", routed)
    jv = tp.with_bn_state(tp.jax_variables(tp.TINY_FULL_JAX), seed=7)
    jian = JaxIAN(config_path=tp.TINY_FULL_JAX, variables=tp.as_jax(jv))
    tian = IAN(tp.TINY_FULL_TORCH, variables=from_reference(jv, "cpu"), device="cpu", mdblock_mode="fused")
    rng = np.random.RandomState(14)
    before = (tk.mdblock_fused.launches, tk.mdblock_fused.launches_bwd)
    calls = 0
    for box in ((10, 12, 20, 22), (-3, 60, 4, 70)):
        z = rng.randn(1, 16).astype(np.float32)
        rgb = np.broadcast_to(rng.uniform(-1, 1, (1, 3, 1, 1)), (1, 3, 64, 64)).astype(np.float32)
        for got, want in ((tian.imgrad(*box, z), jian.imgrad(*box, z)),
                          (tian.imgradRGB(*box, rgb, z), jian.imgradRGB(*box, rgb, z))):
            calls += 1
            assert np.abs(got).max() > 1e-3
            tp.assert_close(got, want)
    assert (tk.mdblock_fused.launches - before[0], tk.mdblock_fused.launches_bwd - before[1]) == (3 * calls,
                                                                                                 3 * calls)
