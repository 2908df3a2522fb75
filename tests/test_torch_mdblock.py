"""npe_tpu_torch's MDBLOCK against npe_tpu's on the same numpy inputs: tap
offsets, tap stacking, the plain version of the `mdblock_fused` kernel
against npe_tpu's reference and its Pallas kernel in interpret mode, and
`models.common.mdblock` in both forms against npe_tpu's, forward and gradient
to x (mirroring tests/test_pallas.py's two MDBLOCK tests). On the CPU the
port's wrapper runs the kernel's plain version.

Tolerances are those of tests/test_pallas.py: rtol 1e-4 / atol 1e-5 forward,
rtol 1e-3 / atol 1e-4 for gradients (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parity as tp
from npe_tpu.models import common as jcommon
from npe_tpu.ops import mdcl as jmdcl
from npe_tpu.ops.pallas import mdcl_kernels as jk
from npe_tpu_torch.models import common as tcommon
from npe_tpu_torch.ops import mdcl as tmdcl
from npe_tpu_torch.ops.kernels import mdblock as tk
from npe_tpu_torch.utils.checkpoints import from_reference

tp.torch_threads()

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
# (scales, map size): full IAN's two scale sets, at test_pallas.py's map sizes
CASES = [((0, 2, 3), 16), ((0, 2), 8)]


def _block(c, scales, size, seed, batch=2):
    """An MDBLOCK named 'blk' as npe_tpu variables (numpy), with filters at
    unit gain, per-channel coefficients that differ and non-trivial BN state
    in all three norms; and an input (batch, size, size, c) NHWC."""
    rng = np.random.RandomState(seed)
    v = {}
    for name in ("blk", "blk2"):
        v[f"{name}W"] = (rng.randn(3, 3, c, c) / np.sqrt(2.2 * c)).astype(np.float32)
        v[f"{name}_coeff_base"] = rng.uniform(0.2, 0.5, c).astype(np.float32)
        for s in scales:
            v[f"{name}_coeff_{'1x1' if s == 0 else s}"] = rng.uniform(0.2, 0.5, c).astype(np.float32)
    for i in range(3):
        v[f"blkbnorm{i}.mean"] = rng.uniform(-0.2, 0.3, c).astype(np.float32)
        v[f"blkbnorm{i}.inv_std"] = rng.uniform(0.8, 1.3, c).astype(np.float32)
        v[f"blkbnorm{i}.beta"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
        v[f"blkbnorm{i}.gamma"] = rng.uniform(0.9, 1.1, c).astype(np.float32)
    x = (rng.randn(batch, size, size, c) * 0.7).astype(np.float32)
    return v, x


def _jnp(v):
    return {k: jnp.asarray(a) for k, a in v.items()}


def _jax_kernel_inputs(v, scales):
    v = _jnp(v)
    taps = [jcommon._stacked_mdcl_taps(v, n, list(scales)) for n in ("blk", "blk2")]
    affines = sum((jcommon._bn_affine(v, f"blkbnorm{i}") for i in range(3)), ())
    return taps[0], taps[1], affines


def _port_kernel_inputs(tv, scales):
    taps = [tcommon._stacked_mdcl_taps(tv, n, scales) for n in ("blk", "blk2")]
    affines = torch.stack([a for i in range(3) for a in tcommon._bn_affine(tv, f"blkbnorm{i}")])
    return taps[0], taps[1], affines


@pytest.mark.parametrize("scales", [(0, 2), (0, 2, 3), (2, 3, 4), (0,), ()])
def test_tap_offsets_match_npe_tpu(scales):
    assert tk.tap_offsets(scales) == jk.tap_offsets(list(scales))
    assert len(tk.tap_offsets(scales)) == 9 * len(tk.dilations(scales))
    assert tk.dilations(scales) == (1,) + tuple(s for s in scales if s)


@pytest.mark.parametrize("scales", [(0, 2), (0, 2, 3), (2, 3, 4)])
def test_stack_mdcl_taps_matches_npe_tpu(scales):
    v, _ = _block(8, scales, 8, seed=1)
    v["blkW"] = v["blkW"][:, :, :, :6]  # Cin 8, Cout 6: the two axes cannot be mixed up
    for k in list(v):
        if k.startswith("blk_coeff"):
            v[k] = v[k][:6]
    want = np.asarray(jcommon._stacked_mdcl_taps(_jnp(v), "blk", list(scales)))
    tv = from_reference(v, "cpu")
    assert tuple(tv["blkW"].shape) == (6, 8, 3, 3)
    got = tcommon._stacked_mdcl_taps(tv, "blk", scales)
    assert got.shape == (9 * len(tk.dilations(scales)), 8, 6) and got.is_contiguous()
    tp.assert_close(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_stack_mdcl_taps_passes_gradients_to_the_weights():
    v, _ = _block(8, (0, 2), 8, seed=2)
    tv = {k: t.requires_grad_(True) for k, t in from_reference(v, "cpu").items()}
    taps = tcommon._stacked_mdcl_taps(tv, "blk", (0, 2))
    grads = torch.autograd.grad(taps.square().sum(), [tv["blkW"], tv["blk_coeff_base"], tv["blk_coeff_1x1"]])
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("scales,size", CASES)
def test_plain_version_matches_npe_tpu_reference_and_interpret_kernel(scales, size):
    v, x = _block(8, scales, size, seed=3)
    offs = jk.tap_offsets(list(scales))
    jt1, jt2, jaff = _jax_kernel_inputs(v, scales)
    want_ref = np.asarray(jk.mdblock_taps_reference(jnp.asarray(x), jt1, jt2, jaff, offs))
    want_kernel = np.asarray(jk.mdblock_fused(jnp.asarray(x), jt1, jt2, jaff, offs, 4, True))
    t1, t2, aff = _port_kernel_inputs(from_reference(v, "cpu"), scales)
    got = tp.nhwc(tk.mdblock_taps_reference(tp.nchw(x), t1, t2, aff, scales))
    assert want_ref.std() > 0.2  # unit-gain filters: not a match of zeros
    tp.assert_close(got, want_ref, **FWD)
    tp.assert_close(got, want_kernel, **FWD)


@pytest.mark.parametrize("scales,size", CASES)
def test_plain_version_gradients_match_npe_tpu(scales, size):
    """The backward of the port's kernel is this VJP: to x, both tap tensors
    and the affines, against jax.grad of npe_tpu's reference."""
    v, x = _block(8, scales, size, seed=4)
    offs = jk.tap_offsets(list(scales))
    jt1, jt2, jaff = _jax_kernel_inputs(v, scales)
    want = jax.grad(lambda *a: jnp.sum(jk.mdblock_taps_reference(*a, offs) ** 2), argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jt1, jt2, jaff)
    leaves = [t.detach().requires_grad_(True)
              for t in (tp.nchw(x),) + _port_kernel_inputs(from_reference(v, "cpu"), scales)]
    got = torch.autograd.grad(tk.mdblock_taps_reference(*leaves, scales).square().sum(), leaves)
    tp.assert_close(tp.nhwc(got[0]), want[0], **GRAD)
    tp.assert_close(got[1].numpy(), want[1], **GRAD)
    tp.assert_close(got[2].numpy(), want[2], **GRAD)
    tp.assert_close(got[3].numpy(), np.stack([np.asarray(a) for a in want[3]]), **GRAD)


@pytest.mark.parametrize("mode", ["plain", "fused"])
@pytest.mark.parametrize("scales,size", CASES)
def test_mdblock_matches_npe_tpu_mdblock(scales, size, mode):
    """`models.common.mdblock(train=False)` in each form against npe_tpu's
    per-op form, forward and gradient to x; the fused form goes through the
    in-situ tap stacking, the affines and the kernel's wrapper (C = 16, the
    kernel's channel step)."""
    v, x = _block(16, scales, size, seed=5)
    jv = _jnp(v)
    jf = lambda x: jcommon.mdblock(jv, None, "blk", x, list(scales), jcommon.LRELU, False)  # noqa: E731
    want = np.asarray(jf(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jf(x) ** 2))(jnp.asarray(x)))
    tv = from_reference(v, "cpu")
    xt = tp.nchw(x).requires_grad_(True)
    before = tk.mdblock_fused.launches
    got = tcommon.mdblock(tv, None, "blk", xt, scales, tcommon.LRELU, False, mode=mode)
    (got_g,) = torch.autograd.grad(got.square().sum(), xt)
    assert tk.mdblock_fused.launches == before  # CPU tensors: the plain version, no launch
    assert want.std() > 0.2
    tp.assert_close(tp.nhwc(got), want, **FWD)
    tp.assert_close(tp.nhwc(got_g), want_g, **GRAD)


@pytest.mark.parametrize("scales,size", CASES)
def test_both_forms_agree_and_the_default_is_plain(scales, size):
    v, x = _block(16, scales, size, seed=6)
    tv, xt = from_reference(v, "cpu"), tp.nchw(x)
    assert tcommon.MDBLOCK_MODE == "plain" and tcommon.MDBLOCK_MODES == ("plain", "fused")
    default = tcommon.mdblock(tv, None, "blk", xt, scales, tcommon.LRELU, False)
    plain = tcommon.mdblock(tv, None, "blk", xt, scales, tcommon.LRELU, False, mode="plain")
    fused = tcommon.mdblock(tv, None, "blk", xt, scales, tcommon.LRELU, False, mode="fused")
    assert torch.equal(default, plain)
    tp.assert_close(fused.numpy(), plain.numpy(), **FWD)
    assert not torch.equal(fused, plain)  # another order of sums: really another path


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_train_takes_the_per_op_form_in_either_mode(mode):
    """Batch statistics do not fold to an affine: with train=True both modes
    run the per-op form, equal to npe_tpu's, BN updates included."""
    scales = (0, 2, 3)
    v, x = _block(16, scales, 16, seed=7, batch=4)
    jv = _jnp(v)
    jupd, tupd, pupd = {}, {}, {}
    want = np.asarray(jcommon.mdblock(jv, jupd, "blk", jnp.asarray(x), list(scales), jcommon.LRELU, True))
    tv, xt = from_reference(v, "cpu"), tp.nchw(x)
    got = tcommon.mdblock(tv, tupd, "blk", xt, scales, tcommon.LRELU, True, mode=mode)
    tp.assert_close(tp.nhwc(got), want, **FWD)
    assert sorted(tupd) == sorted(jupd) and len(tupd) == 6
    for k in jupd:
        tp.assert_close(tupd[k].numpy(), jupd[k], **FWD)
    assert torch.equal(got, tcommon.mdblock(tv, pupd, "blk", xt, scales, tcommon.LRELU, True, mode="plain"))


def test_mdblock_raises_on_an_unknown_mode_and_on_another_activation():
    v, x = _block(16, (0, 2), 8, seed=8)
    tv, xt = from_reference(v, "cpu"), tp.nchw(x)
    with pytest.raises(ValueError, match="unknown MDBLOCK mode"):
        tcommon.mdblock(tv, None, "blk", xt, (0, 2), tcommon.LRELU, False, mode="pallas")
    with pytest.raises(ValueError, match="LeakyReLU"):
        tcommon.mdblock(tv, None, "blk", xt, (0, 2), torch.relu, False, mode="fused")
    assert tcommon.mdblock(tv, None, "blk", xt, (0, 2), torch.relu, False, mode="plain").min() >= 0


@pytest.mark.parametrize("scales", [(0, 2), (0, 2, 3), (2, 3, 4)])
def test_mdcl_apply_branch_matches_composed_and_npe_tpu(scales):
    v, x = _block(8, scales, 16, seed=9)
    jv = _jnp(v)
    coeffs = {s: jv[f"blk_coeff_{'1x1' if s == 0 else s}"] for s in scales}
    want = np.asarray(jmdcl.mdcl_apply_branch(jnp.asarray(x), jv["blkW"], jv["blk_coeff_base"], coeffs, list(scales)))
    tv = from_reference(v, "cpu")
    tcoeffs = {s: tv[f"blk_coeff_{'1x1' if s == 0 else s}"] for s in scales}
    args = (tp.nchw(x), tv["blkW"], tv["blk_coeff_base"], tcoeffs, scales)
    branch, composed = tmdcl.mdcl_apply_branch(*args), tmdcl.mdcl_apply(*args)
    tp.assert_close(tp.nhwc(branch), want, **FWD)
    tp.assert_close(branch.numpy(), composed.numpy(), **FWD)


def _wrapper_inputs(c=16, size=8, scales=(0, 2)):
    v, x = _block(c, scales, size, seed=10)
    return (tp.nchw(x),) + _port_kernel_inputs(from_reference(v, "cpu"), scales)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    x, t1, t2, aff = _wrapper_inputs()
    before = tk.mdblock_fused.launches
    got = tk.mdblock_fused(x, t1, t2, aff, (0, 2))
    assert torch.equal(got, tk.mdblock_taps_reference(x, t1, t2, aff, (0, 2)))
    assert tk.mdblock_fused.launches == before
    assert tk.REPLACES == "npe_tpu/ops/pallas/mdcl_kernels.py:119" and tk.SOURCE.endswith("csrc/mdblock.cu")


@pytest.mark.parametrize("fault,error,match", [
    ("float64", TypeError, "float32"),
    ("strided", ValueError, "contiguous"),
    ("channels_last", ValueError, "contiguous"),
    ("taps_for_other_scales", ValueError, "shape"),
    ("affines_as_rows", ValueError, "shape"),
    ("eight_channels", ValueError, "multiple of 16"),
    ("small_map", ValueError, "multiple of 64"),
    ("three_dims", ValueError, "multiple of 16"),
])
def test_wrapper_raises_on_what_the_kernel_cannot_take(fault, error, match):
    """The wrapper checks before it looks at the device, so these hold for
    CUDA tensors too: it never reads a tensor wrongly and never copies."""
    x, t1, t2, aff = _wrapper_inputs()
    scales = (0, 2)
    if fault == "float64":
        x = x.double()
    elif fault == "strided":
        x = x.transpose(2, 3)
    elif fault == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif fault == "taps_for_other_scales":
        scales = (0, 2, 3)
    elif fault == "affines_as_rows":
        aff = aff.t().contiguous()
    elif fault == "eight_channels":
        x, t1, t2, aff = _wrapper_inputs(c=8)
    elif fault == "small_map":
        x, t1, t2, aff = _wrapper_inputs(size=4)
    elif fault == "three_dims":
        x = x[0]
    with pytest.raises(error, match=match):
        tk.mdblock_fused(x, t1, t2, aff, scales)


FULL_IAN = [(512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3))]  # chip_smoke.py's MDBLOCK_SHAPES
H100_SMS = 132


@pytest.mark.parametrize("batch,channels,shape,scales", [
    *((batch, c, (size, size), scales) for c, size, scales in FULL_IAN for batch in (1, 8, 16, 128)),
    (2, 16, (8, 8), (0, 2)), (3, 32, (16, 16), (0, 2, 3)),  # the tiny profile's widths
    (3, 80, (16, 16), (2, 3, 4)),  # a part-full channel tile, halo tiles of radius 4
    (2, 32, (4, 16), (0, 2)),  # a 4x16 map: its 8x8 patches half outside
    (2, 64, (16, 16), (0, 10)),  # a dilation whose halo does not fit: a window a unit
])
def test_the_forward_plan_at_full_ians_shapes(batch, channels, shape, scales):
    """`fwd_plan` on the H100: halo tiles and four tap stages at full IAN's
    shapes, a window a unit only where the halo tiles and three stages do
    not fit; two patches a block (one halo buffer each, one slice) once the
    tiles give each SM two, so at batch 128; its shared memory fits a block
    and is what the kernel asks for; with one patch a block the slices
    partition the units with at least BWD_MIN_UNITS each, a cluster holds at
    most 8 blocks and divides the slices, the blocks run in one wave (one an
    SM, no more clusters than the card holds) and at one image fill most of
    the SMs, at most three groups of slices taking the second sum launch,
    and the cut is the backward's; the launches by `fwd_launches`."""
    h, w = shape
    plan = tk.fwd_plan(batch, channels, h, w, scales, H100_SMS)
    radius = max(tk.dilations(scales))
    sub = plan.sub_tiles
    assert plan.smem == tk.fwd_smem_bytes(plan.halo, plan.stages, radius, sub) <= tk.SMEM_PER_BLOCK
    assert plan.halo == (tk.fwd_smem_bytes(True, 3, radius, sub) <= tk.SMEM_PER_BLOCK)
    assert plan.stages == 4 or tk.fwd_smem_bytes(plan.halo, plan.stages + 1, radius, sub) > tk.SMEM_PER_BLOCK
    if (channels, h, scales) in FULL_IAN:
        assert plan.halo and plan.stages == 4
    tiles = batch * -(-h // 8) * -(-w // 8) * -(-channels // 128)
    assert sub == (2 if tiles >= 2 * H100_SMS and tk.fwd_smem_bytes(True, 3, radius, 2) <= tk.SMEM_PER_BLOCK else 1)
    assert sub == 1 or (plan.halo and plan.splits == plan.cluster == 1)
    if batch == 128:
        assert sub == 2
    units = -(-channels // 32) * 9 * len(tk.dilations(scales))
    bounds = [s * units // plan.splits for s in range(plan.splits + 1)]
    assert min(b - a for a, b in zip(bounds, bounds[1:])) >= min(tk.BWD_MIN_UNITS, units)
    assert 1 <= plan.cluster <= tk.MAX_CLUSTER == 8 and plan.splits % plan.cluster == 0
    if plan.splits > 1:
        assert tiles * plan.splits <= H100_SMS
        assert tiles * plan.splits // plan.cluster <= tk.CLUSTER_SLOTS[plan.cluster]
    if batch == 1 and (channels, h, scales) in FULL_IAN:
        assert tiles * plan.splits > H100_SMS // 2 and plan.splits // plan.cluster <= 3
    assert tk.fwd_launches(plan) == (3 if plan.splits == plan.cluster else 5)
    if plan.halo and sub == 1:
        back = tk.bwd_plan(batch, channels, h, w, scales, torch.float32, H100_SMS)
        assert (plan.stages, plan.splits, plan.cluster, plan.smem) == (back.stages, back.splits, back.cluster,
                                                                       back.smem)


def _emulated_float32_forward(x, taps1, taps2, aff, scales, plan, products=3):
    """The float32 forward kernel's arithmetic in float32 on the CPU: each
    MDCL's input (lrelu(s0 x + t0), then h1) as a TF32 (hi, lo) pair
    (`tf32_split`), each unit (a chunk of 32 input channels by one tap) a
    stage of lo*hi + hi*lo + hi*hi of the pair's shifted window and the split
    tap (or hi*hi alone, `products=1`), summed from zero and added to float32
    running sums; with one patch a block each slice of the plan's units two
    sums, of its even and of its odd units (the block's two consumer
    warpgroups), added in that order, the slices added in cluster order,
    then the clusters in order; with two patches a block one sum over every
    unit in order; the epilogues' affines, lrelus and the residual in
    float32. (A product of two TF32
    values is exact in float32; the tensor cores' truncation is what the
    per-stage sums keep from growing.)"""
    n, c, hh, ww = x.shape
    offs = tk.tap_offsets(scales)
    r = max(tk.dilations(scales))
    units = [(ch, t) for ch in range(-(-c // 32)) for t in range(len(offs))]
    s0, t0, s1, t1, s2, t2 = (a[None, :, None, None] for a in aff)

    def sum_in_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    def mdcl(v, taps):
        hi, lo = (F.pad(a, (r, r, r, r)) for a in tk.tf32_split(v))

        def window(a, t, cs):  # (n, pixels, k)
            dy, dx = offs[t]
            return a[:, cs, r + dy:r + dy + hh, r + dx:r + dx + ww].flatten(2).transpose(1, 2)

        slices = []
        for s in range(plan.splits):
            acc = [torch.zeros(n, hh * ww, c) for _ in range(2)]
            for k, (ch, t) in enumerate(units[s * len(units) // plan.splits:(s + 1) * len(units) // plan.splits]):
                cs = slice(ch * 32, (ch + 1) * 32)
                b_hi, b_lo = tk.tf32_split(taps[t][cs])  # (ci, co)
                a_hi, a_lo = window(hi, t, cs), window(lo, t, cs)
                w = k % 2 if plan.sub_tiles == 1 else 0
                acc[w] = acc[w] + (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi if products == 3 else a_hi @ b_hi)
            slices.append(acc[0] + acc[1])
        clusters = [sum_in_order(slices[i:i + plan.cluster]) for i in range(0, plan.splits, plan.cluster)]
        return sum_in_order(clusters).transpose(1, 2).reshape(n, c, hh, ww)

    lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
    h1 = lrelu(mdcl(lrelu(x * s0 + t0), taps1) * s1 + t1)
    return lrelu((x + mdcl(h1, taps2)) * s2 + t2)


@pytest.mark.parametrize("sub_tiles", [1, 2])
@pytest.mark.parametrize("channels,size,scales", FULL_IAN)
def test_the_float32_forward_arithmetic_keeps_float32_accuracy_and_one_product_does_not(channels, size, scales,
                                                                                        sub_tiles):
    """Why the float32 forward takes three TF32 products per multiply-add of
    its pixel-major (hi, lo) pairs: full IAN's blocks on chip_smoke.py's
    inputs at one image, on the plan's slices and clusters there (one patch
    a block) and on its plan at batch 128 (two patches a block, one slice);
    the emulated kernel (`_emulated_float32_forward`) against the float64
    plain version stays within a quarter of the card's rule (1e-5 of the
    largest value, tests/test_torch_cuda.py) and of MDBLOCK_TOL; hi*hi alone
    misses both."""
    from chip_smoke import MDBLOCK_TOL, mdblock_inputs

    x, t1, t2, aff = mdblock_inputs(1, channels, size, scales, 43, "cpu")
    want = tk.mdblock_taps_reference(*(a.double() for a in (x, t1, t2, aff)), scales)
    plan = tk.fwd_plan(1 if sub_tiles == 1 else 128, channels, size, size, scales, H100_SMS)
    assert plan.halo and plan.sub_tiles == sub_tiles
    assert (plan.splits > 1 and plan.cluster > 1) if sub_tiles == 1 else plan.splits == 1
    tol = min(1e-5 * float(want.abs().max()), MDBLOCK_TOL)
    three = _emulated_float32_forward(x, t1, t2, aff, scales, plan)
    one = _emulated_float32_forward(x, t1, t2, aff, scales, plan, products=1)
    err3, err1 = (float((a.double() - want).abs().max()) for a in (three, one))
    assert float(want.std()) > 0.5
    assert err3 <= tol / 4, (err3, tol)
    assert err1 > tol, (err1, tol)


def test_tf32_split_rounds_as_cvt_rna_does():
    """Ten mantissa bits kept, to nearest with ties away from zero; hi + lo
    holds the value to 2^-21 of its size."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -1 - 2**-11, 1 + 2**-12, 3.0e-30])
    hi, lo = tk.tf32_split(x)
    assert hi.tolist()[:5] == [1.0, 1 + 2**-10, 1 + 2**-9, -1 - 2**-10, 1.0]
    assert torch.equal(hi + lo, x)
    y = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32))
    hi, lo = tk.tf32_split(y)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(hi, dtype=torch.int32))
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0**-21


def test_three_tf32_products_keep_float32_accuracy_and_one_does_not():
    """Why the kernel takes three TF32 products per multiply-add. One MDCL of
    full IAN's 8x8x512 block (18 taps: 9,216-term sums) on chip_smoke.py's
    inputs, as the kernel's implicit GEMM, with the TF32 products emulated
    (a product of two TF32 values is exact in float32): lo*hi + hi*lo +
    hi*hi stays within MDBLOCK_TOL of float64, hi*hi alone does not."""
    from chip_smoke import MDBLOCK_TOL, mdblock_inputs

    scales = (0, 2)
    x, taps, _, aff = mdblock_inputs(1, 512, 8, scales, 41, "cpu")
    h = F.leaky_relu(x * aff[0, :, None, None] + aff[1, :, None, None], 0.2)
    offs = tk.tap_offsets(scales)
    hp = F.pad(h, (2, 2, 2, 2))
    a = torch.cat([hp[0, :, 2 + dy:10 + dy, 2 + dx:10 + dx].reshape(512, 64).t() for dy, dx in offs], 1)
    b = taps.reshape(-1, 512)  # (taps x Cin, Cout): rows in the order of a's columns
    want = a.double() @ b.double()
    assert torch.allclose(want.float(), tk._mdcl_taps(h, taps, offs).reshape(512, 64).t(), rtol=1e-4, atol=1e-4)
    (a_hi, a_lo), (b_hi, b_lo) = tk.tf32_split(a), tk.tf32_split(b)
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    one = a_hi @ b_hi
    err3, err1 = float((three.double() - want).abs().max()), float((one.double() - want).abs().max())
    assert float(want.std()) > 1
    assert err3 <= MDBLOCK_TOL / 20, err3
    assert err1 > MDBLOCK_TOL, err1


@pytest.mark.parametrize("batch,channels,size,scales,want", [
    # full IAN's three blocks: one image takes one patch a block (two an SM where they fit: R = 2)
    # and slices of at least 4 units
    (1, 512, (8, 8), (0, 2), (True, 1, 128, 36)), (1, 256, (16, 16), (0, 2, 3), (True, 1, 128, 16)),
    (1, 128, (32, 32), (0, 2, 3), (True, 1, 128, 8)),
    (8, 512, (8, 8), (0, 2), (True, 1, 128, 8)), (8, 128, (32, 32), (0, 2, 3), (True, 1, 128, 1)),
    (3, 512, (8, 8), (0, 2), (True, 1, 128, 22)),
    # batch 128 fills the card: two patches a block, 256 channels where C has them, one slice
    (128, 512, (8, 8), (0, 2), (True, 2, 256, 1)), (128, 256, (16, 16), (0, 2, 3), (True, 2, 256, 1)),
    (128, 128, (32, 32), (0, 2, 3), (True, 2, 128, 1)),
    # two patches a block whose 256-channel tap ring and halo would not fit: 128 channels
    (256, 256, (8, 8), (2, 3, 4), (True, 2, 128, 1)),
    # a 4x16 map has no 8x8 patches, and a dilation of 10 no halo that fits: rows mode
    (2, 32, (4, 16), (0, 2), (False, 1, 128, 4)), (2, 64, (16, 16), (0, 10), (False, 1, 128, 4)),
    # a channel count that is not a multiple of 64 has a short last chunk
    (2, 48, (8, 8), (0, 2), (True, 1, 128, 4)), (3, 80, (16, 16), (2, 3, 4), (True, 1, 128, 11)),
])
def test_bf16_plan_by_batch(batch, channels, size, scales, want):
    """The bf16 kernel's tiles and slices as a stated rule of the shape:
    halo tiles where the sides are multiples of 8 and the halo fits; two
    patches a block once the output tiles give each of the card's 132 SMs
    two, then 256 output channels a block where C has them and the block's
    shared memory fits; slices that fill the card's slots, at least
    BF16_MIN_UNITS units each."""
    h, w = size
    plan = tk.bf16_plan(batch, channels, h, w, scales, 132)
    assert tuple(plan) == want
    units = -(-channels // tk.BF16_CHANNEL_STEP) * 9 * len(tk.dilations(scales))
    patches = batch * h * w // tk.TILE_PIXELS
    blocks = -(-patches // plan.sub_tiles) * -(-channels // plan.tile_channels)
    assert plan.splits == 1 or (units // plan.splits >= tk.BF16_MIN_UNITS and blocks * plan.splits <= 2 * 132)
    radius = max(tk.dilations(scales))
    assert tk.bf16_smem_bytes(plan.sub_tiles, plan.halo, radius, plan.tile_channels) <= tk.SMEM_PER_BLOCK


def test_bf16_shared_memory_by_mode():
    """A block's shared memory: a ring of four tap stages of 64 x 128 (16
    KB) or 64 x 256 (32 KB) bf16 taps, then per patch two halo tiles of
    (8 + 2R)^2 pixels x 64 channels, or a ring of four 8 KB windows in rows
    mode, then four 8-byte stage barriers."""
    assert tk.bf16_smem_bytes(1, True, 2) == 4 * 16384 + 2 * 144 * 128 + 32
    assert tk.bf16_smem_bytes(2, True, 3) == 4 * 16384 + 2 * 2 * 196 * 128 + 32
    assert tk.bf16_smem_bytes(2, True, 3, 256) == 4 * 32768 + 2 * 2 * 196 * 128 + 32 <= tk.SMEM_PER_BLOCK
    assert tk.bf16_smem_bytes(2, False, 10) == 4 * 16384 + 2 * 4 * 8192 + 32
    assert tk.bf16_smem_bytes(2, True, 5) <= tk.SMEM_PER_BLOCK < tk.bf16_smem_bytes(2, True, 6)
    assert tk.bf16_smem_bytes(2, True, 4, 256) > tk.SMEM_PER_BLOCK
