"""The RGB-Beta head: the port's tap packing, the plain versions of its two
hand-written kernels, the four head forms and their gradients against
npe_tpu (its Pallas kernels in interpret mode), on the CPU. The CUDA kernels
themselves are held to the plain versions on the GPU by `chip_smoke.py` and
by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import torch_parity as tp
from npe_tpu.models import common as jcommon
from npe_tpu.ops.pallas import mdcl_kernels as jk
from npe_tpu_torch.models import common as tcommon
from npe_tpu_torch.ops.beta import beta_mean
from npe_tpu_torch.ops.kernels import rgb_beta_head as th
from npe_tpu_torch.ops.kernels import rgb_beta_tail as tt
from npe_tpu_torch.utils.checkpoints import from_reference, unit_gain

tp.torch_threads()

SCALES = [2, 3, 4]
RR = 16
MODES = ("plain", "packed", "hybrid", "fused")


def _head_variables(c, seed=0):
    """The head's five MDCLs from npe_tpu's VarBuilder at unit gain, with
    coefficients moved off their common init value: (npe_tpu arrays, port
    tensors)."""
    vb = jcommon.VarBuilder(jax.random.PRNGKey(seed))
    for name, cin in (("R", c), ("G_a", c), ("G_b", 2), ("B_a", c), ("B_b", 4)):
        vb.mdcl(name, cin, 2, SCALES)
    jv = unit_gain(vb.v)
    rng = np.random.RandomState(seed)
    for k in jv:
        if "_coeff_" in k:
            jv[k] = (jv[k] * rng.uniform(0.5, 1.5, jv[k].shape)).astype(np.float32)
    return jv, from_reference(jv, "cpu")


def _head(tv, h, mode):
    """One of the four forms of the head. "packed", all library calls, is
    the fused kernel's plain version over the weights the fused form
    makes: the direct trunk, then the tail over the packed maps."""
    if mode == "packed":
        taps = tcommon.packed_head_weights(tv, SCALES, 4, as_taps=True)
        return th.rgb_beta_head_reference(h, *taps, SCALES)
    return tcommon.rgb_beta_head(tv, h, SCALES, mode=mode)


def _features(n, c, seed):
    return (np.random.RandomState(seed).randn(n, 64, 64, c) * 0.5).astype(np.float32)


def _dense_kernels(jv):
    k_trunk = jnp.concatenate([jcommon._composed_mdcl_kernel(jv, n, SCALES) for n in ("R", "G_a", "B_a")], -1)
    return k_trunk, jcommon._composed_mdcl_kernel(jv, "G_b", SCALES), jcommon._composed_mdcl_kernel(jv, "B_b", SCALES)


def _tail_inputs(n, seed):
    rng = np.random.RandomState(seed)
    trunk = rng.randn(n, 16, 16, 6 * RR).astype(np.float32)  # npe_tpu's NHWC, component-major
    tg = (rng.randn(9, 2 * RR, 2 * RR) * 0.1).astype(np.float32)
    tb = (rng.randn(9, 4 * RR, 2 * RR) * 0.07).astype(np.float32)
    return trunk, tg, tb


def test_pack_head_taps_matches_jax_in_both_input_orders():
    rng = np.random.RandomState(0)
    k = rng.randn(9, 9, 3, 2).astype(np.float32)  # HWIO
    got = tt.pack_head_taps(tp.oihw(k), 4)
    assert got.shape == (9, 3 * RR, 2 * RR) and got.is_contiguous()
    # component-major rows, the order inside npe_tpu's kernels: equal as is
    np.testing.assert_array_equal(got.numpy(), np.asarray(jk.pack_head_taps(jnp.asarray(k), 4, True)))
    # position-major rows, the order of npe_tpu's space_to_depth input
    want = np.asarray(jk.pack_head_taps(jnp.asarray(k), 4, False))
    np.testing.assert_array_equal(tp.position_major(got.numpy(), RR, axis=1), want)
    with pytest.raises(ValueError, match="not 3x3"):
        tt.pack_head_taps(torch.zeros(2, 3, 11, 11), 4)


def test_tail_plain_version_matches_the_pallas_kernel():
    trunk, tg, tb = _tail_inputs(2, 1)
    want = np.asarray(jk.rgb_beta_tail_pallas(jnp.asarray(trunk), jnp.asarray(tg), jnp.asarray(tb), RR, 8, True))
    args = (tp.nchw(trunk), torch.from_numpy(tg), torch.from_numpy(tb))
    got = tt.rgb_beta_tail_reference(*args)
    assert got.shape == (2, 3 * RR, 16, 16) and np.abs(want).std() > 0.1
    tp.assert_close(tp.nhwc(got), want, rtol=1e-4, atol=1e-5)
    before = tt.rgb_beta_tail.launches
    assert torch.equal(tt.rgb_beta_tail(*args), got)  # CPU tensors: the plain version
    assert tt.rgb_beta_tail.launches == before  # and no launch is counted


def test_head_plain_version_matches_the_pallas_kernel_at_full_width():
    jv, tv = _head_variables(64)
    h = _features(1, 64, 2)
    want = np.asarray(jk.rgb_beta_head_pallas(jnp.asarray(h), *_dense_kernels(jv), 4, 1, True))
    taps = tcommon.packed_head_weights(tv, SCALES, 4, as_taps=True)
    conv_kernel, *tail_taps = tcommon.packed_head_weights(tv, SCALES, 4, as_taps=False)
    assert conv_kernel.shape == (96, 16 * 64, 3, 3)
    assert all(torch.equal(a, b) for a, b in zip(tail_taps, taps[1:]))
    assert taps[0].shape == (36, 64, 6)  # 55 KB of stacked taps, not the s2d form's 3.5 MB
    got = th.rgb_beta_head_reference(tp.nchw(h), *taps, SCALES)
    assert got.shape == (1, 3, 64, 64) and np.abs(want).std() > 0.1
    tp.assert_close(tp.nhwc(got), want, rtol=1e-4, atol=1e-5)
    before = th.rgb_beta_head.launches
    assert torch.equal(th.rgb_beta_head(tp.nchw(h), *taps, SCALES), got)
    assert th.rgb_beta_head.launches == before
    # the full-width forms against each other and against npe_tpu's plain head
    plain = np.asarray(jcommon.rgb_beta_head(jv, jnp.asarray(h), SCALES, mode="plain"))
    for mode in MODES:
        out = _head(tv, tp.nchw(h), mode)
        tp.assert_close(tp.nhwc(out), plain, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c", [64, 8])
def test_head_direct_trunk_matches_pallas_and_the_packed_reference(c):
    """The fused form's plain version, the direct trunk over the stacked taps
    of R, G_a and B_a, against npe_tpu's Pallas head (interpret mode) and
    its packed reference, from the same seeded weights."""
    jv, tv = _head_variables(c, seed=3)
    h = _features(2, c, 9)
    dense = _dense_kernels(jv)
    want = np.asarray(jk.rgb_beta_head_pallas(jnp.asarray(h), *dense, 4, 1, True))
    packed = np.asarray(jk.rgb_beta_head_reference_packed(jnp.asarray(h), *dense, 4))
    taps = tcommon.packed_head_weights(tv, SCALES, 4, as_taps=True)
    assert taps[0].shape == (36, c, 6)
    got = tp.nhwc(th.rgb_beta_head_reference(tp.nchw(h), *taps, SCALES))
    assert np.abs(want).std() > 0.1
    tp.assert_close(got, want)
    tp.assert_close(got, packed)


def test_fused_head_gradients_in_float64_match_jax():
    """d sum(head(h)^2) / d h and / d every MDCL weight and coefficient,
    through what the fused form computes from the weights (stacked taps,
    then its plain version, whose VJP is the kernel's backward), in float64
    against npe_tpu's plain head under x64. (The kernel wrapper itself takes
    float32 only.)"""
    jv, tv = _head_variables(8, seed=4)
    h = _features(2, 8, 11).astype(np.float64)
    with tp.x64():
        jgrad_h, jgrad_v = jax.grad(
            lambda h, v: jnp.sum(jcommon.rgb_beta_head(v, h, SCALES, mode="plain") ** 2), argnums=(0, 1)
        )(jnp.asarray(h), {k: jnp.asarray(a, jnp.float64) for k, a in jv.items()})
    th_ = tp.nchw(h).requires_grad_(True)
    tv = {k: t.double().requires_grad_(True) for k, t in tv.items()}
    taps = tcommon.packed_head_weights(tv, SCALES, 4, as_taps=True)
    loss = (th.rgb_beta_head_reference(th_, *taps, SCALES) ** 2).sum()
    names = sorted(tv)
    grads = torch.autograd.grad(loss, [th_] + [tv[k] for k in names])
    assert np.asarray(jgrad_h).dtype == np.float64 and np.abs(np.asarray(jgrad_h)).max() > 1e-2
    tp.assert_close(tp.nhwc(grads[0]), jgrad_h, rtol=1e-7, atol=1e-7)
    for k, g in zip(names, grads[1:]):
        want = np.asarray(jgrad_v[k])
        tp.assert_close(tp.hwio(g) if g.ndim == 4 else g.numpy(), want, rtol=1e-7, atol=1e-7 * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_head_forms_match_jax_plain(mode):
    jv, tv = _head_variables(8)
    h = _features(2, 8, 3)
    want = np.asarray(jcommon.rgb_beta_head(jv, jnp.asarray(h), SCALES, mode="plain"))
    got = _head(tv, tp.nchw(h), mode)
    assert got.shape == (2, 3, 64, 64)
    assert want.std() > 0.1 and np.abs(want).max() <= 1.0  # Beta means, not zeros
    tp.assert_close(tp.nhwc(got), want, rtol=1e-4, atol=1e-5)
    # npe_tpu's own hybrid form reaches its Pallas tail kernel in interpret mode
    if mode == "hybrid":
        hyb = np.asarray(jcommon.rgb_beta_head(jv, jnp.asarray(h), SCALES, mode="hybrid"))
        tp.assert_close(tp.nhwc(got), hyb, rtol=1e-4, atol=1e-5)


def test_head_mode_default_and_fallbacks():
    """The default is "hybrid", a constant; there is no fallback: a kernel
    form on a shape its kernel cannot take raises, and only a caller who
    names "plain" gets the plain form."""
    assert tcommon.HEAD_MODE == "hybrid" and tcommon.HEAD_MODES == ("plain", "hybrid", "fused")
    jv, tv = _head_variables(4)
    h = tp.nchw(_features(1, 4, 4))
    before = tt.rgb_beta_tail.launches, th.rgb_beta_head.launches
    assert torch.equal(tcommon.rgb_beta_head(tv, h, SCALES), tcommon.rgb_beta_head(tv, h, SCALES, mode="hybrid"))
    assert (tt.rgb_beta_tail.launches, th.rgb_beta_head.launches) == before
    # a map the block does not divide: the plain form takes it, the kernel forms refuse
    odd = h[:, :, :62, :62].contiguous()
    want = np.asarray(jcommon.rgb_beta_head(jv, jnp.asarray(tp.nhwc(odd)), SCALES, mode="plain"))
    tp.assert_close(tp.nhwc(tcommon.rgb_beta_head(tv, odd, SCALES, mode="plain")), want, rtol=1e-4, atol=1e-5)
    for mode in ("hybrid", "fused"):
        with pytest.raises(ValueError, match="divisible by 4"):
            tcommon.rgb_beta_head(tv, odd, SCALES, mode=mode)
        # block 2 packs the 9x9 kernels to 5x5 taps, not the kernels' 3x3
        with pytest.raises(ValueError, match="not 3x3"):
            tcommon.rgb_beta_head(tv, h, SCALES, mode=mode, block=2)
        # 5x5 kernels at block 2 pack to 3x3 taps, but the kernels are compiled for block 4
        with pytest.raises(ValueError, match="has shape"):
            tcommon.rgb_beta_head(tv, h, [2], mode=mode, block=2)
        # a wider map than the kernels' 16 cells: fused wants W = 64, the tail its shared memory
        # (a block holds maps up to 77 cells wide)
        with pytest.raises(ValueError, match="rgb_beta_"):
            tcommon.rgb_beta_head(tv, torch.zeros(1, 4, 64, 320), SCALES, mode=mode)
    # scales up to 3 still pack to 3x3 taps at block 4: the kernel forms take them
    small = tcommon.rgb_beta_head(tv, h, [2, 3], mode="plain")
    for mode in ("hybrid", "fused"):
        tp.assert_close(tcommon.rgb_beta_head(tv, h, [2, 3], mode=mode).numpy(), small.numpy(), rtol=1e-4, atol=1e-5)
    for unknown in ("pallas", "packed"):
        with pytest.raises(ValueError, match="unknown RGB-Beta head mode"):
            tcommon.rgb_beta_head(tv, h, SCALES, mode=unknown)


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_head_gradients_match_jax(mode):
    """d sum(head(h)^2) / d h and / d every MDCL weight and coefficient."""
    jv, tv = _head_variables(8, seed=1)
    h = _features(2, 8, 5)
    jgrad_h, jgrad_v = jax.grad(
        lambda h, v: jnp.sum(jcommon.rgb_beta_head(v, h, SCALES, mode="packed") ** 2), argnums=(0, 1)
    )(jnp.asarray(h), {k: jnp.asarray(a) for k, a in jv.items()})
    th_ = tp.nchw(h).requires_grad_(True)
    tv = {k: t.requires_grad_(True) for k, t in tv.items()}
    loss = (tcommon.rgb_beta_head(tv, th_, SCALES, mode=mode) ** 2).sum()
    names = sorted(tv)
    grads = torch.autograd.grad(loss, [th_] + [tv[k] for k in names])
    assert np.abs(np.asarray(jgrad_h)).max() > 1e-2
    tp.assert_close(tp.nhwc(grads[0]), jgrad_h)
    for k, g in zip(names, grads[1:]):
        want = np.asarray(jgrad_v[k])
        tp.assert_close(tp.hwio(g) if g.ndim == 4 else g.numpy(), want)


def test_kernel_backward_is_the_plain_versions_vjp():
    """On the GPU the autograd.Function's backward calls `vjp_of_plain`; here
    it is held to autograd through the plain version, taps included."""
    trunk, tg, tb = _tail_inputs(1, 6)
    ins = [tp.nchw(trunk), torch.from_numpy(tg), torch.from_numpy(tb)]
    g = torch.randn(1, 3 * RR, 16, 16, generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(tt.rgb_beta_tail_reference(*leaves), leaves, g)
    got = tt.vjp_of_plain(tt.rgb_beta_tail_reference, (True, True, True), ins, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(not t.requires_grad for t in ins)  # the saved tensors stay untouched
    only_trunk = tt.vjp_of_plain(tt.rgb_beta_tail_reference, (True, False, False), ins, g)
    assert torch.equal(only_trunk[0], want[0]) and only_trunk[1:] == (None, None)
    # the same for the whole head, against jax.grad through the Pallas kernel's custom VJP
    jv, tv = _head_variables(8, seed=2)
    h = _features(1, 8, 7)
    dense = _dense_kernels(jv)
    jg = jax.grad(lambda h: jnp.sum(jk.rgb_beta_head_pallas(h, *dense, 4, 1, True) ** 2))(jnp.asarray(h))
    taps = list(tcommon.packed_head_weights(tv, SCALES, 4, as_taps=True))
    x = tp.nchw(h)
    out = th.rgb_beta_head_reference(x, *taps, SCALES)
    plain = lambda *a: th.rgb_beta_head_reference(*a, SCALES)  # noqa: E731
    gx, *_ = tt.vjp_of_plain(plain, (True, False, False, False), [x] + taps, 2 * out)
    tp.assert_close(tp.nhwc(gx), jg)


def test_wrappers_refuse_what_the_kernels_cannot_read():
    trunk, tg, tb = _tail_inputs(1, 8)
    trunk, tg, tb = tp.nchw(trunk), torch.from_numpy(tg), torch.from_numpy(tb)
    with pytest.raises(TypeError, match="float32"):
        tt.rgb_beta_tail(trunk.double(), tg, tb)
    with pytest.raises(ValueError, match="contiguous"):
        tt.rgb_beta_tail(trunk.transpose(2, 3), tg, tb)
    with pytest.raises(ValueError, match="tb_taps has shape"):
        tt.rgb_beta_tail(trunk, tg, tg)
    with pytest.raises(ValueError, match=r"\(N, 96, H, W\) trunk"):
        tt.rgb_beta_tail(trunk[0], tg, tb)
    with pytest.raises(ValueError, match="H even"):
        tt.rgb_beta_tail(trunk[:, :, :15].contiguous(), tg, tb)
    with pytest.raises(ValueError, match="trunk has shape"):
        tt.rgb_beta_tail(trunk[:, :48], tg, tb)
    with pytest.raises(ValueError, match="shared memory"):  # a block holds maps 78 cells wide
        tt.rgb_beta_tail(torch.zeros(1, 96, 16, 78), tg, tb)
    assert tt.rgb_beta_tail(torch.zeros(1, 96, 32, 32), tg, tb).shape == (1, 48, 32, 32)  # any height
    assert tt.rgb_beta_tail(torch.zeros(1, 96, 2, 77), tg, tb).shape == (1, 48, 2, 77)
    x = torch.zeros(1, 8, 64, 64)
    tr = torch.zeros(36, 8, 6)
    with pytest.raises(TypeError, match="float32"):
        th.rgb_beta_head(x.double(), tr, tg, tb, SCALES)
    with pytest.raises(ValueError, match="contiguous"):
        th.rgb_beta_head(x.transpose(2, 3), tr, tg, tb, SCALES)
    with pytest.raises(ValueError, match="trunk_taps has shape"):
        th.rgb_beta_head(x, tr[:, :4], tg, tb, SCALES)
    with pytest.raises(ValueError, match="trunk_taps has shape"):  # taps for other scales
        th.rgb_beta_head(x, tr, tg, tb, [2, 3])
    for bad in (torch.zeros(1, 8, 20, 64), torch.zeros(1, 8, 64, 32), torch.zeros(0, 8, 64, 64)):
        with pytest.raises(ValueError, match="H a multiple of 8"):
            th.rgb_beta_head(bad, tr, tg, tb, SCALES)
    with pytest.raises(ValueError, match="dilations of at most 4"):  # the trunk kernel's halo
        th.rgb_beta_head(x, torch.zeros(27, 8, 6), tg, tb, [2, 5])
    assert th.rgb_beta_head(x, tr, tg, tb, SCALES).shape == (1, 3, 64, 64)
    # the direct trunk takes any channel count and any height of whole cell-row pairs
    assert th.rgb_beta_head(torch.zeros(1, 7, 24, 64), torch.zeros(36, 7, 6), tg, tb, SCALES).shape == (1, 3, 24, 64)


def test_head_slices_fill_the_card_for_a_small_batch():
    """The trunk's channel slices: 16 bands x 8 slices = 128 blocks for one
    image on 132 multiprocessors, fewer slices as the batch grows (the most
    that keep the blocks within two a multiprocessor; scripts/kernel_sweep.py
    found that count the fastest at every batch it timed), never more than
    8 or the channels."""
    assert [th.head_slices(b, 16, 64, 132) for b in (1, 2, 3, 4, 8, 9, 16, 128)] == [8, 8, 5, 4, 2, 1, 1, 1]
    assert th.head_slices(1, 16, 128, 132) == 8  # full IAN: 16 channels a slice
    assert th.head_slices(1, 16, 3, 132) == 3 and th.head_slices(1, 16, 1, 132) == 1
    for batch in (1, 2, 5, 8, 64, 500):
        s = th.head_slices(batch, 16, 64, 132)
        assert 1 <= s <= th.MAX_SLICES and (s == 1 or batch * 16 * s <= 2 * 132)


def test_tail_rows_and_shared_memory_of_the_row_group_kernel():
    """The fewest cell rows a block that keep the blocks in one wave, a
    divisor of the height whose maps fit; past that, the most. A block's
    shared memory follows the map's width and its rows, not its height, and
    at w = 16 two blocks of any row count fit no SM."""
    assert [tt.tail_rows(b, 16, 16, 132) for b in (1, 8, 9, 16, 64, 128, 200)] == [1, 1, 2, 2, 8, 16, 16]
    assert [tt.tail_rows(b, 2, 16, 132) for b in (1, 66, 67, 500)] == [1, 1, 2, 2]
    assert tt.tail_rows(200, 6, 5, 132) == 6 and tt.tail_rows(40, 6, 5, 132) == 2
    assert tt.tail_rows(128, 16, 77, 132) == 1  # at 77 cells wide a block's maps hold one row at most
    assert tt.tail_smem_bytes(16) == (9 * 32 * 32 + 9 * 64 * 32 + 64 * 6 * 18) * 4 == 138240
    assert tt.tail_smem_bytes(16) < tt.tail_smem_bytes(16, rows=2) < tt.SMEM_LIMIT < 2 * tt.tail_smem_bytes(16)
    assert tt.tail_smem_bytes(16, rows=16) <= tt.SMEM_LIMIT
    assert tt.tail_smem_bytes(77) <= tt.SMEM_LIMIT < tt.tail_smem_bytes(78)
    assert tt.tail_smem_bytes(77, rows=2) > tt.SMEM_LIMIT


def _tail_by_row_groups(trunk, tg, tb, rows):
    """The kernel's cut of an image, in PyTorch: for each group of `rows`
    cell rows, R on the rows +-2 and G on the rows +-1 from the trunk's
    slice alone, zero outside the map, then B on the group's rows."""
    pair = 2 * RR
    n, _, h, w = trunk.shape
    out = []
    for i0 in range(0, h, rows):
        lo, hi = max(i0 - 2, 0), min(i0 + rows + 2, h)
        pad = (0, 0, lo - (i0 - 2), i0 + rows + 2 - hi)  # rows beyond the map are zero
        red = F.pad(torch.sigmoid(trunk[:, :pair, lo:hi]), pad)
        grn = torch.sigmoid(F.pad(trunk[:, pair:2 * pair, lo:hi], pad) + tt.tap_conv(red, tg))
        inside = torch.tensor([0 <= i0 - 2 + r < h for r in range(rows + 4)], dtype=trunk.dtype)
        grn = grn * inside[None, None, :, None]  # G is zero outside the map, as B's border
        blu = torch.sigmoid(trunk[:, 2 * pair:, i0:i0 + rows] + tt.tap_conv(torch.cat([red, grn], 1), tb)[:, :, 2:-2])
        out.append(torch.cat([beta_mean(c[:, :RR], c[:, RR:]) for c in (red[:, :, 2:-2], grn[:, :, 2:-2], blu)], 1))
    return torch.cat(out, 2)


@pytest.mark.parametrize("rows", [1, 2, "all"])
@pytest.mark.parametrize("h,w", [(16, 16), (2, 16), (6, 5)])
def test_row_groups_with_a_halo_of_two_compute_the_whole_tail(rows, h, w):
    """R two rows beyond a group and G one are all that B on the group's rows
    needs: the groups' results put together are the plain version's."""
    rows = h if rows == "all" else rows
    rng = np.random.RandomState(h * w + rows)
    trunk = torch.from_numpy(rng.randn(2, 6 * RR, h, w).astype(np.float32))
    tg = torch.from_numpy((rng.randn(9, 2 * RR, 2 * RR) * 0.1).astype(np.float32))
    tb = torch.from_numpy((rng.randn(9, 4 * RR, 2 * RR) * 0.07).astype(np.float32))
    want = tt.rgb_beta_tail_reference(trunk, tg, tb)
    got = _tail_by_row_groups(trunk, tg, tb, rows)
    assert float(want.std()) > 0.1
    tp.assert_close(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
