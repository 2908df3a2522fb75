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


@pytest.mark.parametrize("batch,channels,size,scales,want", [
    (1, 512, 8, (0, 2), 64), (1, 256, 16, (0, 2, 3), 27), (1, 128, 32, (0, 2, 3), 12),  # one image
    (8, 512, 8, (0, 2), 8), (128, 512, 8, (0, 2), 1), (128, 128, 32, (0, 2, 3), 1),
])
def test_inner_splits_fill_one_wave_of_the_card(batch, channels, size, scales, want):
    """The most slices (a divisor of the inner dimension's 16-channel steps)
    that still let every block of the call run at once, BLOCKS_PER_SM to a
    multiprocessor of 132; one slice once the batch fills the card."""
    units = 9 * len(tk.dilations(scales)) * channels // tk.CHANNEL_STEP
    tiles = (size * size // tk.TILE_PIXELS) * -(-channels // tk.TILE_CHANNELS)
    got = tk.inner_splits(batch, tiles, units, 132)
    assert got == want and units % got == 0
    assert got == 1 or batch * tiles * got <= tk.BLOCKS_PER_SM * 132


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
