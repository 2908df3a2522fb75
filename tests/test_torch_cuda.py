"""Tests of npe_tpu_torch that need an NVIDIA GPU (marker `cuda`; each skips
without one). This file imports no JAX, so that it runs where JAX is not
installed, without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pathlib

import numpy as np
import pytest
import torch

from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.models import get_config
from npe_tpu_torch.models import common
from npe_tpu_torch.ops.kernels import edit_tail as et
from npe_tpu_torch.ops.kernels import mdblock as mk
from npe_tpu_torch.ops.kernels import rgb_beta_head as rh
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain

TINY = str(pathlib.Path(__file__).resolve().parent / "tiny_ian_torch.py")
TINY_V1 = str(pathlib.Path(__file__).resolve().parent / "tiny_ianv1_torch.py")
TINY_FULL = str(pathlib.Path(__file__).resolve().parent / "tiny_ian_full_torch.py")
HEAD_SCALES = (2, 3, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(batch, user_mask, device):
    rng = np.random.RandomState(5)
    xh, recon = (rng.rand(batch, 64, 64, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    err = rng.rand(batch, 64, 64, 3).astype(np.float32) * 0.2
    um = {None: None, "random": rng.rand(batch, 64, 64).astype(np.float32),
          "ones": np.ones((batch, 64, 64), np.float32)}[user_mask]
    return [None if a is None else torch.from_numpy(a).to(device) for a in (xh, recon, err, um)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("user_mask", [None, "random", "ones"])
@pytest.mark.parametrize("sigma", [0.7, 1.5, 3.0])  # radius 3, 6 and 12: wider than a band at batch 1
def test_edit_tail_kernel_matches_plain(cuda, batch, user_mask, sigma):
    xh, recon, err, um = _inputs(batch, user_mask, cuda)
    before = et.edit_tail.launches
    got = et.edit_tail(xh, recon, err, um, sigma)
    torch.cuda.synchronize()
    assert et.edit_tail.launches == before + 1
    want = et.edit_tail_reference(xh, recon, err, et.blur_matrix(64, sigma, device=cuda), um)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_tiny_session_on_the_card_matches_the_cpu(cuda):
    """The tiny profile's session on the card and on the CPU, from the same
    weights: each composite step launches the kernel once."""
    variables = get_config(TINY).init(torch.Generator().manual_seed(0), "cpu")
    sessions = [
        EditSession(TINY, variables={k: v.to(d) for k, v in variables.items()}, dim=(4, 4), device=d)
        for d in (cuda, "cpu")
    ]
    image = np.random.RandomState(3).uniform(-0.5, 0.5, (3, 64, 64)).astype(np.float32)
    before = et.edit_tail.launches
    for s in sessions:
        s.infer(image)
        s.paint_stroke(10, 10, 20, 20, (255, 0, 0))
        s.paint_stroke(30, 5, 50, 25, (0, 255, 0), 0.5)
    assert et.edit_tail.launches == before + 2
    card, cpu = sessions
    np.testing.assert_allclose(card.Z.cpu().numpy(), cpu.Z.numpy(), rtol=1e-3, atol=1e-4)
    assert np.isfinite(card.IM).all()


def _head_inputs(batch, c, device, seed=6, cells=(16, 16), height=64):
    """Seeded O(1) features and tap matrices at unit gain: the trunk's
    stacked taps for HEAD_SCALES (36 taps, 33 distinct offsets), the tail's
    over the trunk of `cells` (h, w)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, c, height, 64).astype(np.float32)
    tr = (rng.randn(36, c, 6) / np.sqrt(33 * c)).astype(np.float32)
    trunk = rng.randn(batch, 96, *cells).astype(np.float32)
    tg = (rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)
    tb = (rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, tr, trunk, tg, tb)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,cells", [
    (1, (16, 16)), (8, (16, 16)), (16, (16, 16)), (128, (16, 16)),  # one row a block at 1 and 8, two at 16, 128
    (1, (2, 16)), (3, (2, 5)),  # the smallest map height the wrapper takes
    (1, (32, 32)), (2, (6, 77)),  # taller than the first kernel took; the widest a block holds
])
def test_rgb_beta_tail_kernel_matches_plain(cuda, batch, cells):
    _, _, trunk, tg, tb = _head_inputs(batch, 2, cuda, cells=cells)
    before = rt.rgb_beta_tail.launches
    got = rt.rgb_beta_tail(trunk, tg, tb)
    torch.cuda.synchronize()
    assert rt.rgb_beta_tail.launches == before + 1
    want = rt.rgb_beta_tail_reference(trunk, tg, tb)
    assert float(want.std()) > 0.1
    assert float((got - want).abs().max()) <= 1e-5
    leaves = [t.clone().requires_grad_(True) for t in (trunk, tg, tb)]
    got_g = torch.autograd.grad((rt.rgb_beta_tail(*leaves) ** 2).sum(), leaves)
    want_g = torch.autograd.grad((rt.rgb_beta_tail_reference(*leaves) ** 2).sum(), leaves)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,channels", [(1, 64), (8, 64), (16, 64), (1, 128), (1, 8), (3, 8),
                                            (2, 64), (3, 64), (2, 128), (1, 7), (1, 3), (128, 64)])
def test_rgb_beta_head_kernel_matches_plain(cuda, batch, channels):
    """Slice counts from 8 to 1 (by batch, fewer when C is small), uneven
    slices (C = 7, and 5 slices of 64 at batch 3), and one image's result
    bit-equal from call to call (the slices are added in a fixed order)."""
    x, tr, _, tg, tb = _head_inputs(batch, channels, cuda)
    before = rh.rgb_beta_head.launches
    got = rh.rgb_beta_head(x, tr, tg, tb, HEAD_SCALES)
    torch.cuda.synchronize()
    assert rh.rgb_beta_head.launches == before + 1
    want = rh.rgb_beta_head_reference(x, tr, tg, tb, HEAD_SCALES)
    assert got.shape == (batch, 3, 64, 64) and float(want.std()) > 0.1
    # the trunk sums 36 * C terms in another order than the plain version's per-tap products
    assert float((got - want).abs().max()) <= 5e-5
    assert torch.equal(rh.rgb_beta_head(x, tr, tg, tb, HEAD_SCALES), got)
    xg = x.clone().requires_grad_(True)
    (got_g,) = torch.autograd.grad((rh.rgb_beta_head(xg, tr, tg, tb, HEAD_SCALES) ** 2).sum(), xg)
    (want_g,) = torch.autograd.grad((rh.rgb_beta_head_reference(xg, tr, tg, tb, HEAD_SCALES) ** 2).sum(), xg)
    torch.testing.assert_close(got_g, want_g, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("height,scales", [(8, HEAD_SCALES), (24, HEAD_SCALES), (64, (2, 3)), (64, (0, 2))])
def test_rgb_beta_head_kernel_takes_other_heights_and_scales(cuda, height, scales):
    """Maps of any height of whole cell-row pairs (the halo reaches past a
    map of two bands), and fewer dilations (27 or 18 taps; scale 0 folded
    into the centre)."""
    rng = np.random.RandomState(height)
    n_taps = 9 * len(mk.dilations(scales))
    x = torch.from_numpy(rng.randn(2, 16, height, 64).astype(np.float32)).to(cuda)
    tr = torch.from_numpy((rng.randn(n_taps, 16, 6) / np.sqrt(n_taps * 16)).astype(np.float32)).to(cuda)
    _, _, _, tg, tb = _head_inputs(1, 1, cuda)
    got = rh.rgb_beta_head(x, tr, tg, tb, scales)
    want = rh.rgb_beta_head_reference(x, tr, tg, tb, scales)
    assert got.shape == (2, 3, height, 64) and float(want.std()) > 0.1
    assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_wrappers_raise_on_the_card_too(cuda):
    x, tr, trunk, tg, tb = _head_inputs(1, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rt.rgb_beta_tail(trunk.transpose(2, 3), tg, tb)
    with pytest.raises(ValueError, match="is on"):
        rt.rgb_beta_tail(trunk, tg.cpu(), tb)
    with pytest.raises(TypeError, match="float32"):
        rh.rgb_beta_head(x.half(), tr, tg, tb, HEAD_SCALES)
    with pytest.raises(ValueError, match="trunk_taps has shape"):
        rh.rgb_beta_head(x, tr, tg, tb, (2, 3))
    before = rt.rgb_beta_tail.launches
    with pytest.raises(ValueError, match="shared memory"):  # maps 78 cells wide: more than a block holds
        rt.rgb_beta_tail(torch.zeros(1, 96, 2, 78, device=cuda), tg, tb)
    with pytest.raises(ValueError, match="H even"):
        rt.rgb_beta_tail(torch.zeros(1, 96, 3, 16, device=cuda), tg, tb)
    assert rt.rgb_beta_tail.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_tiny_ianv1_session_on_the_card_matches_the_cpu(cuda, mode):
    """The tiny IANv1 profile's session on the card and on the CPU from the
    same unit-gain weights: each decode launches the head's kernel once (a
    stroke decodes twice, infer once), each composite the tail's."""
    seeded = get_config(TINY_V1).init(torch.Generator().manual_seed(0), "cpu")
    reference = unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1)
    sessions = [EditSession(TINY_V1, variables=from_reference(reference, d), dim=(4, 4), device=d,
                            head_mode=mode)
                for d in (cuda, "cpu")]
    image = np.random.RandomState(3).uniform(-0.5, 0.5, (3, 64, 64)).astype(np.float32)
    counter = rt.rgb_beta_tail if mode == "hybrid" else rh.rgb_beta_head
    other = rh.rgb_beta_head if mode == "hybrid" else rt.rgb_beta_tail
    before = (counter.launches, other.launches, et.edit_tail.launches)
    for s in sessions:
        s.infer(image)
        s.paint_stroke(10, 10, 20, 20, (255, 0, 0))
        s.paint_stroke(30, 5, 50, 25, (0, 255, 0), 0.5)
    assert counter.launches == before[0] + 5
    assert other.launches == before[1]
    assert et.edit_tail.launches == before[2] + 2
    card, cpu = sessions
    np.testing.assert_allclose(card.Z.cpu().numpy(), cpu.Z.numpy(), rtol=1e-3, atol=1e-4)
    assert np.isfinite(card.IM).all() and np.abs(card.DELTA).max() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_head_kernel_forms_raise_on_shapes_their_kernels_cannot_take(cuda, mode):
    """On the card a kernel form launches its kernel or raises: a map the
    block does not divide, or another block, never drops to library convs."""
    seeded = get_config(TINY_V1).init(torch.Generator().manual_seed(0), cuda)
    h = torch.zeros(1, 8, 64, 64, device=cuda)
    before = (rt.rgb_beta_tail.launches, rh.rgb_beta_head.launches)
    with pytest.raises(ValueError, match="divisible by 4"):
        common.rgb_beta_head(seeded, h[:, :, :62, :62].contiguous(), mode=mode)
    with pytest.raises(ValueError, match="not 3x3"):
        common.rgb_beta_head(seeded, h, mode=mode, block=2)
    assert (rt.rgb_beta_tail.launches, rh.rgb_beta_head.launches) == before
    assert common.rgb_beta_head(seeded, h, mode=mode).shape == (1, 3, 64, 64)
    assert sum((rt.rgb_beta_tail.launches, rh.rgb_beta_head.launches)) == sum(before) + 1


def _mdblock_inputs(batch, c, size, scales, device, seed=7):
    """Seeded O(1) features, tap tensors at unit gain and non-trivial affines."""
    rng = np.random.RandomState(seed)
    n_taps = 9 * len(mk.dilations(scales))
    x = rng.randn(batch, c, size, size).astype(np.float32)
    taps = [(rng.randn(n_taps, c, c) / np.sqrt(2.2 * c)).astype(np.float32) for _ in range(2)]
    aff = np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, *taps, aff)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,channels,size,scales", [
    # full IAN's three blocks at batch 1 (slices summed in clusters), 8 and 128 (two patches a block)
    (1, 512, 8, (0, 2)), (1, 256, 16, (0, 2, 3)), (1, 128, 32, (0, 2, 3)),
    (8, 512, 8, (0, 2)), (8, 256, 16, (0, 2, 3)), (8, 128, 32, (0, 2, 3)),
    (128, 512, 8, (0, 2)), (128, 256, 16, (0, 2, 3)), (128, 128, 32, (0, 2, 3)),
    (2, 16, 8, (0, 2)), (3, 32, 16, (0, 2, 3)),  # the tiny profile's widths
    (3, 80, 16, (2, 3, 4)),  # a channel tile that is only part full; no scale 0
    (600, 64, 8, (0,)),  # more blocks than one wave: one slice, the epilogue in the product kernel
    (265, 48, 8, (0, 2)),  # two patches a block, the last block's second patch past the batch
])
def test_mdblock_kernel_matches_plain(cuda, batch, channels, size, scales):
    x, t1, t2, aff = _mdblock_inputs(batch, channels, size, scales, cuda)
    before = mk.mdblock_fused.launches
    got = mk.mdblock_fused(x, t1, t2, aff, scales)
    torch.cuda.synchronize()
    assert mk.mdblock_fused.launches == before + 1
    want = mk.mdblock_taps_reference(x, t1, t2, aff, scales)
    assert got.shape == x.shape and float(want.std()) > 0.5
    # float32 sums of up to 9216 products in another order, twice in a row
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # x's gradient, the backward kernels: against their plain version, and the
    # plain VJP outside the reach of a slope that parts from the plain forward's
    from chip_smoke import check_mdblock_backward

    check_mdblock_backward(f"batch {batch} C {channels} {size}x{size}", x, t1, t2, aff, scales)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,channels,size,scales", [
    (1, 64, 16, (0, 10)), (8, 32, 16, (0, 2, 5)),  # dilations whose halo tiles do not fit: a window a unit
])
def test_the_float32_forward_takes_a_dilation_past_its_halo(cuda, batch, channels, size, scales):
    """Where two halo buffers and three tap stages do not fit a block,
    `fwd_plan` brings each unit's own shifted window; the forward still
    matches its plain version, and keeps h1 for a backward where x needs one."""
    x, t1, t2, aff = _mdblock_inputs(batch, channels, size, scales, cuda)
    assert not mk.fwd_plan(batch, channels, size, size, scales, 132).halo
    want, h1_want = mk.mdblock_forward_parts(x, t1, t2, aff, scales)
    out, h1, rc = mk._launch_float32(x, t1, t2, aff, scales)
    torch.cuda.synchronize()
    assert rc == 0 and float(want.std()) > 0.5
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((h1 - h1_want).abs().max()) <= 1e-5 * float(h1_want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,channels,size,scales", [
    (1, 512, 8, (0, 2)), (1, 256, 16, (0, 2, 3)), (128, 128, 32, (0, 2, 3)), (1, 64, 16, (0, 10)),
])
def test_the_float32_forwards_kernels_are_the_benchmarks_mdblock_fwd_group(cuda, batch, channels, size, scales):
    """One forward call under torch.profiler: every device kernel it runs
    (its prologue, two MDCLs and, where a tile's slices outnumber a cluster,
    their clusters' sums) is one that the benchmark's roofline counts as the
    MDBLOCK forward (`benchmark/yardstick/bounds.kernel_group`), and they are
    `fwd_launches(plan)` in all."""
    from torch.autograd import DeviceType

    from benchmark.yardstick.bounds import kernel_group

    x, t1, t2, aff = _mdblock_inputs(batch, channels, size, scales, cuda)
    mk.mdblock_fused(x, t1, t2, aff, scales)  # built and warm
    lead = torch.zeros(16, device=cuda)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(16):  # the first records of a window can go missing: these count for nothing
            lead[i:i + 1].add_(1)
        torch.cuda.synchronize()
        mk.mdblock_fused(x, t1, t2, aff, scales)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "elementwise_kernel" not in e.key}
    plan = mk.fwd_plan(batch, channels, size, size, scales, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert kernels and all(kernel_group(name) == "mdblock_fwd" for name in kernels), kernels
    assert sum(kernels.values()) == mk.fwd_launches(plan), (kernels, plan)


@pytest.mark.cuda
def test_mdblock_gradients_reach_the_taps_and_affines_only_when_asked(cuda):
    x, t1, t2, aff = _mdblock_inputs(2, 32, 8, (0, 2), cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, t1, t2, aff)]
    got = torch.autograd.grad((mk.mdblock_fused(*leaves, (0, 2)) ** 2).sum(), leaves)
    want = torch.autograd.grad((mk.mdblock_taps_reference(*leaves, (0, 2)) ** 2).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * float(b.abs().max()))
    out = mk.mdblock_fused(leaves[0], t1, t2, aff, (0, 2))
    assert out.grad_fn is not None and out.grad_fn.next_functions[1][0] is None  # no path to the taps


@pytest.mark.cuda
def test_mdblock_wrapper_raises_on_the_card_too(cuda):
    x, t1, t2, aff = _mdblock_inputs(1, 32, 8, (0, 2), cuda)
    before = mk.mdblock_fused.launches
    with pytest.raises(TypeError, match="float32"):
        mk.mdblock_fused(x.half(), t1, t2, aff, (0, 2))
    with pytest.raises(ValueError, match="contiguous"):
        mk.mdblock_fused(x.contiguous(memory_format=torch.channels_last), t1, t2, aff, (0, 2))
    with pytest.raises(ValueError, match="is on"):
        mk.mdblock_fused(x, t1.cpu(), t2, aff, (0, 2))
    with pytest.raises(ValueError, match="multiple of 16"):
        mk.mdblock_fused(*_mdblock_inputs(1, 8, 8, (0, 2), cuda), (0, 2))
    assert mk.mdblock_fused.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_tiny_ian_session_on_the_card_matches_the_cpu(cuda, mode):
    """The tiny full-IAN profile's session on the card and on the CPU from
    the same unit-gain weights: in the fused form each decode launches the
    MDBLOCK kernel three times (a stroke decodes twice, infer once), in the
    per-op form never."""
    seeded = get_config(TINY_FULL).init(torch.Generator().manual_seed(0), "cpu")
    reference = unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1)
    sessions = [EditSession(TINY_FULL, variables=from_reference(reference, d), dim=(4, 4), device=d,
                            mdblock_mode=mode)
                for d in (cuda, "cpu")]
    image = np.random.RandomState(3).uniform(-0.5, 0.5, (3, 64, 64)).astype(np.float32)
    before = (mk.mdblock_fused.launches, rt.rgb_beta_tail.launches, et.edit_tail.launches)
    for s in sessions:
        s.infer(image)
        s.paint_stroke(10, 10, 20, 20, (255, 0, 0))
        s.paint_stroke(30, 5, 50, 25, (0, 255, 0), 0.5)
    assert mk.mdblock_fused.launches == before[0] + (15 if mode == "fused" else 0)
    assert rt.rgb_beta_tail.launches == before[1] + 5
    assert et.edit_tail.launches == before[2] + 2
    card, cpu = sessions
    np.testing.assert_allclose(card.Z.cpu().numpy(), cpu.Z.numpy(), rtol=1e-3, atol=1e-4)
    assert np.isfinite(card.IM).all() and np.abs(card.DELTA).max() > 1e-2


@pytest.mark.cuda
def test_fused_mdblock_raises_on_a_shape_its_kernel_cannot_take(cuda):
    """On the card the fused form launches its kernel or raises: eight
    channels never drop to the per-op form."""
    vb = common.VarBuilder(torch.Generator().manual_seed(0), cuda)
    for name in ("blk", "blk2"):
        vb.mdcl(name, 8, 8, [0, 2])
    for i in range(3):
        vb.bn(f"blkbnorm{i}", 8)
    x = torch.zeros(1, 8, 8, 8, device=cuda)
    before = mk.mdblock_fused.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        common.mdblock(vb.v, None, "blk", x, (0, 2), common.LRELU, False, mode="fused")
    assert mk.mdblock_fused.launches == before
    assert common.mdblock(vb.v, None, "blk", x, (0, 2), common.LRELU, False, mode="plain").shape == x.shape


# --- the training slice -------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 64), (3, 16, 16)])
@pytest.mark.parametrize("index", ["none", "int64", "int32", "device tensor"])
def test_staging_kernel_matches_plain(cuda, shape, index):
    from npe_tpu_torch.ops.kernels import staging

    rng = np.random.RandomState(4)
    src = torch.from_numpy(rng.randint(0, 256, (300, *shape), dtype=np.uint8)).to(cuda)
    perm = {"none": None, "int64": rng.randint(0, 300, 1000), "int32": rng.randint(0, 300, 7).astype(np.int32),
            "device tensor": torch.from_numpy(rng.permutation(300)).to(cuda)}[index]
    before = staging.stage_chunk.launches
    got = staging.stage_chunk(src, perm)
    torch.cuda.synchronize()
    assert staging.stage_chunk.launches == before + 1
    want = staging.stage_chunk_reference(src, None if perm is None else torch.as_tensor(perm).to(cuda).long())
    assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-6
    assert float(got.min()) >= -1 - 1e-6 and float(got.max()) <= 1 + 1e-6


@pytest.mark.cuda
def test_staging_wrapper_raises_on_the_card(cuda):
    from npe_tpu_torch.ops.kernels import staging

    src = torch.zeros((4, 3, 16, 16), dtype=torch.uint8, device=cuda)
    before = staging.stage_chunk.launches
    with pytest.raises(ValueError):
        staging.stage_chunk(torch.zeros((4, 3, 5, 5), dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError):
        staging.stage_chunk(src.float())
    with pytest.raises(IndexError):
        staging.stage_chunk(src, np.array([4]))
    assert staging.stage_chunk.launches == before
    # a CPU index tensor counts as host indices: checked, then copied up
    assert tuple(staging.stage_chunk(src, torch.zeros(2, dtype=torch.int64)).shape) == (2, 3, 16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("device_cache_bytes", [2 << 30, 0])
def test_tiny_train_on_the_card(cuda, tmp_path, device_cache_bytes):
    import json

    from npe_tpu_torch.ops.kernels import staging
    from npe_tpu_torch.training.train import train
    from npe_tpu_torch.utils.checkpoints import load_train_state

    before = staging.stage_chunk.launches
    state = train(TINY_FULL, "synthetic", max_epochs=2, num_examples=24, out_dir=str(tmp_path),
                  checkpoint_grids=False, device_cache_bytes=device_cache_bytes,
                  cfg_overrides={"batch_size": 4, "batches_per_chunk": 2})
    assert staging.stage_chunk.launches == before + 5  # one per chunk: 3 + 2
    assert all(t.is_cuda for part in state["parts"].values() for t in part.values())
    recs = [json.loads(line) for line in open(tmp_path / "tiny_ian_fullMETRICS.jsonl")]
    assert [r["itr"] for r in recs] == [2, 4, 6, 8, 10]
    assert all(np.isfinite(v) for r in recs for v in r["metrics"].values())
    loaded = load_train_state(str(tmp_path / "tiny_ian_full_train_state.npz"))
    assert int(loaded["step"]) == 10 and loaded["parts"]["gen"]["dec_conv4.W"].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("config", [TINY, TINY_FULL])
def test_one_step_on_the_card_matches_the_cpu(cuda, config):
    """Metrics and BN statistics at the golden tolerance; the gradients in
    float64 (plain head), where no relu rounds to the other side."""
    import types

    from npe_tpu_torch.training import graph, losses
    from npe_tpu_torch.training import train_step as ts

    module = get_config(config)
    plain = types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module) if not k.startswith("__")})
    if module.HAS_IAF:
        plain.decode = lambda v, z, train=False, upd=None: module.decode(v, z, train, upd, head_mode="plain")
        plain.decode_pre_iaf = lambda v, z, train=False, upd=None: module.decode_pre_iaf(
            v, z, train, upd, head_mode="plain")
    cfg = dict(module.cfg)
    seeded = module.init(torch.Generator().manual_seed(0), "cpu")
    variables = from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), "cpu")
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-0.8, 0.8, (4, 3, 64, 64)).astype(np.float32))
    z, eps = (torch.from_numpy(rng.randn(4, cfg["num_latents"]).astype(np.float32)) for _ in range(2))
    for dtype, mod in ((torch.float32, module), (torch.float64, plain)):
        results = []
        for device in (cuda, "cpu"):
            parts = losses.partition_variables({k: v.to(device=device, dtype=dtype) for k, v in variables.items()})
            batch = [t.to(device=device, dtype=dtype) for t in (x, z, eps)]
            for grads_fn in (ts.gen_grads, ts.discrim_grads):
                g_a, g_b, out, upd = grads_fn(mod, cfg, parts, *batch)
                metrics = graph.compute_metrics(cfg, out, batch[0], mod.N_DISCRIM_CLASSES)
                results.append(({k: float(v) for k, v in metrics.items()}, {k: v.cpu() for k, v in upd.items()},
                                {k: g.cpu() for k, g in {**g_a, **g_b}.items()}))
        for (m_a, u_a, g_a), (m_b, u_b, g_b) in zip(results[:2], results[2:]):
            for k in m_b:
                np.testing.assert_allclose(m_a[k], m_b[k], rtol=1e-3, atol=1e-4, err_msg=k)
            for k in u_b:
                np.testing.assert_allclose(u_a[k].numpy(), u_b[k].numpy(), rtol=1e-3, atol=1e-4, err_msg=k)
            if dtype == torch.float64:
                for k, want in g_b.items():
                    np.testing.assert_allclose(g_a[k].numpy(), want.numpy(), rtol=1e-5,
                                               atol=1e-6 * float(want.abs().max()) + 1e-10, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [TINY_V1, TINY_FULL])
def test_bf16_train_steps_on_the_card_launch_only_the_bf16_tail(cuda, config):
    """cfg['compute_dtype'] = 'bfloat16': each decode of a step (two a step)
    launches the tail's bf16 form, and its backward's bf16 form runs three
    times a G + D pair (both decodes of the G step, the reconstruction's of
    the D step); no float32 tail, no head or MDBLOCK kernel. Masters stay
    float32, and the metrics track the CPU's bf16 step within npe_tpu's bf16
    trajectory bounds (rtol 0.12 / atol 0.02)."""
    from npe_tpu_torch.training import train_step as ts

    module = get_config(config)
    cfg = dict(module.cfg, compute_dtype="bfloat16")
    variables = _unit_gain_variables(config)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.uniform(-0.8, 0.8, (4, 3, 64, 64)).astype(np.float32))
    z, eps = (torch.from_numpy(rng.randn(4, cfg["num_latents"]).astype(np.float32)) for _ in range(2))
    counts = [(rt.rgb_beta_tail, "launches"), (rt.rgb_beta_tail, "launches_bf16"), (rh.rgb_beta_head, "launches"),
              (rh.rgb_beta_head, "launches_bf16"), (mk.mdblock_fused, "launches"),
              (mk.mdblock_fused, "launches_bf16"), (rt.rgb_beta_tail, "launches_bwd"),
              (rt.rgb_beta_tail, "launches_bwd_bf16")]
    metrics = []
    for device in (cuda, "cpu"):
        state = ts.init_train_state(module, {k: v.to(device) for k, v in variables.items()}, cfg)
        gen_step, discrim_step = ts.make_train_steps(module, cfg)
        before = [getattr(fn, attr) for fn, attr in counts]
        batch = [t.to(device) for t in (x, z, eps)]
        state, m_g = gen_step(state, *batch, 2e-4)
        state, m_d = discrim_step(state, *batch, 2e-4)
        launched = [getattr(fn, attr) - b for (fn, attr), b in zip(counts, before)]
        assert launched == ([0, 4, 0, 0, 0, 0, 0, 3] if device is cuda else [0] * 8), launched
        assert all(t.dtype == torch.float32 for p in ("gen", "latent", "discrim") for t in state["parts"][p].values())
        metrics.append({k: float(v) for m in (m_g, m_d) for k, v in m.items()})
    for k, want in metrics[1].items():
        assert np.isfinite(metrics[0][k])
        np.testing.assert_allclose(metrics[0][k], want, rtol=0.12, atol=0.02, err_msg=k)


@pytest.mark.cuda
def test_tiny_train_on_the_card_from_a_native_file_in_bf16_with_fid_and_a_trace(cuda, tmp_path):
    import json

    from npe_tpu_torch.data import SyntheticFaces
    from npe_tpu_torch.data.native_loader import export_raw
    from npe_tpu_torch.ops.kernels import staging
    from npe_tpu_torch.training.train import train

    raw = tmp_path / "train.raw"
    export_raw(SyntheticFaces(num_examples=24), str(raw))
    before = staging.stage_chunk.launches, rt.rgb_beta_tail.launches_bf16
    train(TINY_V1, f"native:{raw}", max_epochs=1, out_dir=str(tmp_path), checkpoint_grids=False,
          valid_dataset_spec="synthetic", num_valid_examples=8, profile_dir=str(tmp_path / "trace"),
          cfg_overrides={"batch_size": 4, "batches_per_chunk": 2, "compute_dtype": "bfloat16"})
    assert staging.stage_chunk.launches == before[0] + 3  # one per chunk
    assert rt.rgb_beta_tail.launches_bf16 == before[1] + 3 * 2 * 2  # 2 steps a chunk, 2 decodes a step
    recs = [json.loads(line) for line in open(tmp_path / "tiny_ianv1METRICS.jsonl")]
    (valid,) = [r["validation"] for r in recs if "validation" in r]
    assert np.isfinite(valid["encoder_fid"]) and (tmp_path / "tiny_ianv1_fid_basis.npz").is_file()
    (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)  # the card's kernels are in it


# --- serving ------------------------------------------------------------------


def _unit_gain_variables(config):
    seeded = get_config(config).init(torch.Generator().manual_seed(0), "cpu")
    return from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("config,option,mode,counter,per_call", [
    (TINY_V1, "head_mode", "hybrid", "rgb_beta_tail", 1),
    (TINY_V1, "head_mode", "fused", "rgb_beta_head", 1),
    (TINY_FULL, "mdblock_mode", "fused", "mdblock", 3),
])
def test_served_decode_on_the_card_launches_its_kernel(cuda, config, option, mode, counter, per_call):
    """Three 1-image decodes through the server on the card, one group of
    max_batch 4: the form's kernel launches `per_call` times, and the images
    match the same server on the CPU."""
    from npe_tpu_torch.serving import InferenceServer

    kernel = {"rgb_beta_tail": rt.rgb_beta_tail, "rgb_beta_head": rh.rgb_beta_head,
              "mdblock": mk.mdblock_fused}[counter]
    variables = _unit_gain_variables(config)
    z = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    outs = []
    for device in (cuda, "cpu"):
        server = InferenceServer(config, variables={k: v.to(device) for k, v in variables.items()}, max_batch=4,
                                 linger_ms=200.0, device=device, **{option: mode})
        try:
            before = kernel.launches
            futs = [server.decode(z[i:i + 1]) for i in range(3)]
            outs.append(np.concatenate([f.result(timeout=60) for f in futs]))
            assert kernel.launches == before + (per_call * server.stats["batches"] if device == cuda else 0)
            assert server.stats["batches"] >= 1
        finally:
            server.close()
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_uint8_wire_encode_on_the_card_launches_the_staging_kernel(cuda):
    from npe_tpu_torch.ops.kernels import staging
    from npe_tpu_torch.serving import InferenceServer

    variables = _unit_gain_variables(TINY)
    u8 = np.random.RandomState(5).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    outs = []
    for device in (cuda, "cpu"):
        server = InferenceServer(TINY, variables={k: v.to(device) for k, v in variables.items()}, device=device,
                                 wire="uint8")
        try:
            before = staging.stage_chunk.launches
            outs.append(server.encode(u8).result(timeout=60))
            assert staging.stage_chunk.launches == before + (device == cuda)
        finally:
            server.close()
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-3, atol=1e-4)


# --- bfloat16 -----------------------------------------------------------------

BF16 = torch.bfloat16


def _within_bf16_steps(got, want, points=3):
    """bf16 `got` within `points` of bf16's 2^-8 relative steps of |want| +
    std(want): a kernel and its plain version round at the same three points
    and add in other orders (chip_smoke.py's BF16_POINTS)."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    g, w = got.double(), want.double()
    assert float(w.std()) > 0.05
    assert bool(((g - w).abs() <= points * 2.0 ** -8 * (w.abs() + w.std())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,batch", [
    ("tail", 1), ("tail", 16), ("tail", 128), ("tail over a float32 trunk", 1), ("head", 1), ("head", 3),
    ("mdblock 8x8x512", 1), ("mdblock 16x16x256", 8), ("mdblock 32x32x128", 2), ("mdblock 16x16x32", 3),
])
def test_bf16_kernel_forms_match_their_bf16_plain_versions(cuda, kernel, batch):
    """Each bf16 form against its plain version on the same bf16 inputs,
    counted in `launches_bf16` (the float32 count untouched); tail_only is
    the fused head's second launch and counts nothing."""
    if kernel.startswith("mdblock"):
        size, channels = {"8x8x512": (8, 512), "16x16x256": (16, 256), "32x32x128": (32, 128),
                          "16x16x32": (16, 32)}[kernel.split()[1]]
        scales = (0, 2) if size == 8 else (0, 2, 3)
        x, t1, t2, aff = _mdblock_inputs(batch, channels, size, scales, cuda)
        args, fn, plain = (x.to(BF16), t1.to(BF16), t2.to(BF16), aff), mk.mdblock_fused, mk.mdblock_taps_reference
        call, ref = (lambda *a: fn(*a, scales)), (lambda *a: plain(*a, scales))
    else:
        x, tr, trunk, tg, tb = _head_inputs(batch, 64, cuda)
        if kernel == "head":
            fn, args = rh.rgb_beta_head, [t.to(BF16) for t in (x, tr, tg, tb)]
            call, ref = (lambda *a: fn(*a, HEAD_SCALES)), (lambda *a: rh.rgb_beta_head_reference(*a, HEAD_SCALES))
        else:
            fn, ref = rt.rgb_beta_tail, rt.rgb_beta_tail_reference
            args = [trunk if "float32" in kernel else trunk.to(BF16), tg.to(BF16), tb.to(BF16)]
            call = rt.tail_only if "float32" in kernel else fn
    before = (fn.launches, fn.launches_bf16)
    got = call(*args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16) == (before[0], before[1] + (call is not rt.tail_only))
    _within_bf16_steps(got, ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,channels,shape,scales", [
    # full IAN's three blocks at batch 1 and 8 (one patch a block, slices) and 128 (two patches a block)
    (1, 512, (8, 8), (0, 2)), (1, 256, (16, 16), (0, 2, 3)), (1, 128, (32, 32), (0, 2, 3)),
    (8, 512, (8, 8), (0, 2)), (8, 256, (16, 16), (0, 2, 3)), (8, 128, (32, 32), (0, 2, 3)),
    (128, 512, (8, 8), (0, 2)), (128, 256, (16, 16), (0, 2, 3)), (128, 128, (32, 32), (0, 2, 3)),
    (3, 512, (8, 8), (0, 2)),  # an odd batch
    (2, 48, (8, 8), (0, 2)),  # C not a multiple of the 64-channel chunk: a short last chunk
    (3, 80, (16, 16), (2, 3, 4)),  # a part-full channel tile and chunk; no scale 0
    (2, 32, (4, 16), (0, 2)),  # no 8x8 patches: rows mode
])
def test_bf16_mdblock_kernel_matches_plain(cuda, batch, channels, shape, scales):
    """The bf16 MDBLOCK kernel (csrc/mdblock_bf16.cu) against the bf16
    plain version on the same bf16 inputs, counted in `launches_bf16`, and
    x's gradient through the wrapper (the backward kernels, against their
    plain version and the plain version's VJP: chip_smoke.py's
    `check_mdblock_backward`)."""
    h, w = shape
    x, t1, t2, aff = _mdblock_inputs(batch, channels, int((h * w) ** 0.5), scales, cuda)
    x, t1, t2 = x.reshape(batch, channels, h, w).to(BF16), t1.to(BF16), t2.to(BF16)
    before = (mk.mdblock_fused.launches, mk.mdblock_fused.launches_bf16)
    got = mk.mdblock_fused(x, t1, t2, aff, scales)
    torch.cuda.synchronize()
    assert (mk.mdblock_fused.launches, mk.mdblock_fused.launches_bf16) == (before[0], before[1] + 1)
    _within_bf16_steps(got, mk.mdblock_taps_reference(x, t1, t2, aff, scales))
    from chip_smoke import check_mdblock_backward

    check_mdblock_backward(f"bf16 batch {batch} C {channels} {h}x{w}", x, t1, t2, aff, scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("channels,size,scales", [(512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3))])
def test_mdblock_backward_kernels_match_plain_and_repeat_bit_for_bit(cuda, channels, size, scales, batch, dtype):
    """x's gradient through the backward kernels (csrc/mdblock_bwd.cu) at
    full IAN's blocks: against `mdblock_backward_reference` and the plain
    VJP (chip_smoke.py's `check_mdblock_backward`, float32 within
    MDBLOCK_BWD_TOL, bf16 within BF16_POINTS + 1 steps), and two calls of the
    kernels on one input bit-equal (the clusters' fixed-order sums)."""
    from chip_smoke import check_mdblock_backward

    x, t1, t2, aff = _mdblock_inputs(batch, channels, size, scales, cuda, seed=9)
    x, t1, t2 = x.to(dtype), t1.to(dtype), t2.to(dtype)
    check_mdblock_backward(f"{dtype} batch {batch} C {channels} {size}x{size}", x, t1, t2, aff, scales)
    xg = x.clone().requires_grad_(True)
    out = mk.mdblock_fused(xg, t1, t2, aff, scales)  # kept alive: y is one of its saved tensors
    h1, y = out.grad_fn.saved_tensors[4:]
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(batch), device=cuda).to(dtype)
    (a, rc_a), (b, rc_b) = (mk._launch_bwd(g, x, y, h1, t1, t2, aff, scales) for _ in range(2))
    torch.cuda.synchronize()
    assert rc_a == rc_b == 0 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("config,form", [(TINY, {}), (TINY_V1, {"head_mode": "hybrid"}),
                                         (TINY_V1, {"head_mode": "fused"}), (TINY_FULL, {"mdblock_mode": "fused"})])
def test_bf16_session_on_the_card_runs_the_bf16_forms(cuda, config, form):
    """A bf16 session against a float32 one on the card from the same
    unit-gain weights (npe_tpu's bf16 bounds, mean abs: 0.2 on Z, 0.05 on
    the image): every decode launches its head's and MDBLOCKs' bf16 forms,
    none of their float32 forms, and edit_tail stays float32."""
    seeded = get_config(config).init(torch.Generator().manual_seed(0), "cpu")
    variables = from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), cuda)
    image = np.random.RandomState(3).uniform(-0.5, 0.5, (3, 64, 64)).astype(np.float32)
    counters = [(k, attr) for k in (rt.rgb_beta_tail, rh.rgb_beta_head, mk.mdblock_fused, et.edit_tail)
                for attr in ("launches", "launches_bf16") if hasattr(k, attr)]
    states = []
    for dtype in (None, BF16):
        session = EditSession(config, variables=variables, dim=(4, 4), device=cuda, dtype=dtype, **form)
        before = [getattr(k, attr) for k, attr in counters]
        session.infer(image)
        session.paint_stroke(10, 10, 20, 20, (255, 0, 0))
        session.paint_stroke(30, 5, 50, 25, (0, 255, 0), 0.5)
        torch.cuda.synchronize()
        launched = {(k.__name__, attr): getattr(k, attr) - b for (k, attr), b in zip(counters, before)}
        states.append((session.Z.cpu().numpy(), session.IM))
    decodes = 5  # infer once, each stroke twice
    want = {("edit_tail", "launches"): 2}
    if form.get("head_mode") == "fused":
        want[("rgb_beta_head", "launches_bf16")] = decodes
    elif config != TINY:
        want[("rgb_beta_tail", "launches_bf16")] = decodes
    if form.get("mdblock_mode") == "fused":
        want[("mdblock_fused", "launches_bf16")] = 3 * decodes
    assert {k: n for k, n in launched.items() if n} == want
    assert states[1][0].dtype == states[1][1].dtype == np.float32 and np.isfinite(states[1][1]).all()
    assert np.abs(states[1][0] - states[0][0]).mean() < 0.2
    assert np.abs(states[1][1] - states[0][1]).mean() < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_bf16_served_decodes_on_the_card(cuda, wire):
    """A bf16 server on either wire answers in float32, near the float32
    server; under the uint8 wire the staging kernel (float32) stages the
    encodes before the cast."""
    from npe_tpu_torch.ops.kernels import staging
    from npe_tpu_torch.serving import InferenceServer

    variables = {k: v.to(cuda) for k, v in _unit_gain_variables(TINY_V1).items()}
    z = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    outs = []
    for dtype in (None, BF16):
        server = InferenceServer(TINY_V1, variables=variables, device=cuda, dtype=dtype, wire=wire,
                                 head_mode="fused")
        try:
            before = (staging.stage_chunk.launches, rh.rgb_beta_head.launches, rh.rgb_beta_head.launches_bf16)
            y, zz = server.decode(z).result(timeout=60), server.encode(x).result(timeout=60)
            assert staging.stage_chunk.launches - before[0] == (wire == "uint8")
            head = (rh.rgb_beta_head.launches - before[1], rh.rgb_beta_head.launches_bf16 - before[2])
            assert head[dtype is not None] >= 1 and head[dtype is None] == 0  # the form of the server's dtype
            outs.append((y, zz))
        finally:
            server.close()
    (y32, z32), (y16, z16) = outs
    assert y16.dtype == z16.dtype == np.float32
    assert np.abs(y16 - y32).mean() < 0.05 and np.abs(z16 - z32).mean() < 0.2


# --- the library blocks and multi-device training --------------------------------


def _block_case(name, device):
    from npe_tpu_torch.ops import blocks, norm

    gen = torch.Generator().manual_seed(3)
    vb = common.VarBuilder(gen, "cpu")
    x = torch.randn((2, 6, 8, 8), generator=gen)
    if name == "usl":
        blocks.usl_init(vb, "b", 6, 4, [0, 2])
        fn = lambda v, x: blocks.usl_apply(v, "b", x, [0, 2])  # noqa: E731
    elif name == "dsl":
        blocks.dsl_init(vb, "b", 6, 4, [0, 2, 3])
        fn = lambda v, x: blocks.dsl_apply(v, "b", x, [0, 2, 3])  # noqa: E731
    elif name == "inception":
        dicts = [blocks.pd(num_layers=2, num_filters=8, bnorm=1),
                 blocks.pd(num_layers=1, num_filters=4, filter_size=3, style="pool", mode="max", bnorm=0),
                 blocks.pd(num_layers=1, num_filters=4, filter_size=3, style="dilation", dilation=2, bnorm=0)]
        blocks.inception_init(vb, "inc", 6, dicts)
        fn = lambda v, x: blocks.inception_apply(v, {}, "inc", x, dicts, train=True)  # noqa: E731
    else:
        vb.bn("rn", 6)
        fn = lambda v, x: norm.batch_renorm_apply(x, v["rn.beta"], v["rn.gamma"], v["rn.mean"] + 0.3,  # noqa: E731
                                                  v["rn.inv_std"], 1.5, 0.5, True)[0]
    return fn({k: t.to(device) for k, t in vb.v.items()}, x.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["usl", "dsl", "inception", "renorm"])
def test_library_blocks_on_the_card_match_the_cpu(cuda, name):
    np.testing.assert_allclose(_block_case(name, cuda).cpu().numpy(), _block_case(name, "cpu").numpy(),
                               rtol=1e-3, atol=1e-4)


def _gloo_rank(rank, store, out):
    import torch.distributed as dist

    from npe_tpu_torch.parallel import multihost

    mesh = multihost.init_multihost(f"file://{store}", 2, rank, "cuda", backend="gloo",
                                    timeout_s=120)
    try:
        torch.save(multihost.run_demo(mesh, 8, TINY_V1, seed=2), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_step_like_one_process(cuda, tmp_path):
    """Two ranks sharing the card over gloo (all_reduce and all_gather of
    CUDA tensors) run one process's G and D step of the tiny IANv1 profile,
    each rank staging its rows and launching the tail kernel in both steps."""
    import multiprocessing

    from npe_tpu_torch.parallel import multihost

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "store"), str(tmp_path / "out")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
        assert p.exitcode == 0
    want = multihost.run_demo(None, 8, TINY_V1, seed=2, device="cuda")
    for r in range(2):
        got = torch.load(f"{tmp_path}/out.{r}")
        assert got["launches"] == {"staging": 1, "rgb_beta_tail": 4}
        for player in ("gen", "discrim"):
            for k, w in want[player].items():
                np.testing.assert_allclose(got[player][k], w, rtol=1e-3, atol=1e-4, err_msg=f"{player} {k}")


# --- the training step as captured programs (training/captured.py) -----------------

def _captured_and_eager(config, dtype, lrs, nb=6, bs=4):
    """The same chunks, from the same state, generator seed and batch, as
    `make_chunk_rows` runs them captured and eagerly on the card (under
    chip_smoke.py's `deterministic_algorithms`): for each side, each chunk's
    (keys, table, flags), the final state, the tail's float32 launches and
    the rows function. Six steps: an eager G and D, a captured G and D (each
    replayed once), two replays."""
    from chip_smoke import deterministic_algorithms
    from npe_tpu_torch.training import train_step as ts

    module = get_config(config)
    cfg = dict(module.cfg, batch_size=bs)
    variables = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _unit_gain_variables(config).items()}
    state0 = ts.init_train_state(module, {k: v.to("cuda") for k, v in variables.items()}, cfg)
    rng = np.random.RandomState(8)
    x_chunk = torch.from_numpy(rng.uniform(-0.8, 0.8, (nb * bs, 3, 64, 64))).to(device="cuda", dtype=dtype)
    with deterministic_algorithms():
        out = {}
        for eager in (True, False):
            rows = ts.make_chunk_rows(module, cfg, nb, eager=eager)
            gen = torch.Generator("cuda").manual_seed(4)
            before = rt.rgb_beta_tail.launches
            state, chunks = state0, []
            for i, lr in enumerate(lrs):
                state, keys, table, flags, _ = rows(state, x_chunk, i * nb, gen, lr)
                chunks.append((keys, table.clone(), flags))
            torch.cuda.synchronize()
            out[eager] = (chunks, state, rt.rgb_beta_tail.launches - before, rows)
    out["start"] = state0
    return out


def _flat_state(state):
    from chip_smoke import flat_state

    return flat_state(state)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [TINY, TINY_V1, TINY_FULL])
def test_captured_chunk_on_the_card_equals_the_eager_chunk(cuda, config):
    """The tiny IAN_simple in float64 (no hand kernel on its training path)
    to 1e-7 of each tensor's largest value; the tiny IANv1 and full IAN in
    float32 through the tail kernel (2 launches a step, the same count on
    both sides): metric rows at the golden tolerance, the state by
    chip_smoke.py's rule (`check_train_state`: the card's float32
    step does not repeat itself, and Adam's sign-like steps turn rounding
    into steps of lr). The graphs exist after the chunk."""
    from chip_smoke import check_train_state

    dtype = torch.float64 if config == TINY else torch.float32
    out = _captured_and_eager(config, dtype, [2e-4])
    start = out["start"]
    ((w_keys, w_table, w_flags),), w_state, w_launches, _ = out[True]
    ((g_keys, g_table, g_flags),), g_state, g_launches, rows = out[False]
    assert (g_keys, g_flags) == (w_keys, w_flags) and g_launches == w_launches == (0 if config == TINY else 12)
    (runner,) = rows.runners.values()
    assert all(p.graph is not None and (p.calls, p.captures) == (3, 1) for p in runner.programs.values())
    assert g_state is runner.state
    w_flat, g_flat = _flat_state(w_state), _flat_state(g_state)
    assert list(w_flat) == list(g_flat)
    if dtype == torch.float64:
        np.testing.assert_allclose(g_table.cpu().numpy(), w_table.cpu().numpy(), rtol=1e-7, atol=1e-7)
        for path, w in w_flat.items():
            scale = float(w.abs().max()) if w.is_floating_point() and w.numel() else 1.0
            np.testing.assert_allclose(g_flat[path].cpu().numpy(), w.cpu().numpy(), rtol=0, atol=1e-7 * scale,
                                       err_msg=str(path))
        return
    np.testing.assert_allclose(g_table.cpu().numpy(), w_table.cpu().numpy(), rtol=1e-3, atol=1e-4)
    check_train_state(config, g_flat, w_flat, _flat_state(start))


@pytest.mark.cuda
def test_a_failing_capture_raises_on_the_card(cuda):
    """A step body that reads a device value to the host runs eagerly at
    the first call and fails its capture at the second: the capture raises,
    nothing falls back, and the counts are as they were."""
    from npe_tpu_torch.training import captured

    t = torch.ones(4, device=cuda)
    program = captured.Program(lambda: float(t.sum()), torch.cuda.Stream(cuda), torch.cuda.graph_pool_handle())
    program()
    before = captured.read_counts()
    with pytest.raises(RuntimeError):
        program()
    assert program.graph is None and captured.read_counts() == before
    torch.cuda.synchronize()
    assert float((t + 1).sum()) == 8.0  # the card still answers


@pytest.mark.cuda
def test_a_new_lr_between_chunks_is_honoured_without_a_new_capture(cuda):
    """Two chunks of the tiny IAN_simple in float64, the second at another
    learning rate (a 0-d tensor on the card): equal to two eager chunks at
    those rates, and the second chunk replays the first's graphs."""
    out = _captured_and_eager(TINY, torch.float64, [2e-4, torch.tensor(7e-4, device="cuda")])
    (runner,) = out[False][3].runners.values()
    assert all((p.calls, p.captures) == (6, 1) for p in runner.programs.values())
    for (_, w_table, _), (_, g_table, _) in zip(out[True][0], out[False][0]):
        np.testing.assert_allclose(g_table.cpu().numpy(), w_table.cpu().numpy(), rtol=1e-7, atol=1e-7)
    w_flat, g_flat = _flat_state(out[True][1]), _flat_state(out[False][1])
    for path, w in w_flat.items():
        scale = float(w.abs().max()) if w.is_floating_point() and w.numel() else 1.0
        np.testing.assert_allclose(g_flat[path].cpu().numpy(), w.cpu().numpy(), rtol=0, atol=1e-7 * scale,
                                   err_msg=str(path))


# --- the RGB-Beta head's backward kernels (npe_tpu's `_tail_bwd`, `_head_bwd`)


def _assert_close_of_largest(got, want, what):
    """float32: rtol 1e-3 / atol 1e-4 of the largest value (the same sums in
    another order; the taps' gradients sum over every cell of the batch)."""
    assert got.dtype == want.dtype and got.shape == want.shape and bool(torch.isfinite(got).all()), what
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * float(want.abs().max()), msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,cells", [(1, (16, 16)), (16, (16, 16)), (128, (16, 16)), (3, (2, 5)), (2, (6, 77))])
def test_rgb_beta_tail_backward_kernels_match_plain(cuda, batch, cells):
    """dtrunk, dtg and dtb from the backward kernels against
    `rgb_beta_tail_backward_reference`, counted once in `launches_bwd`; the
    trunk's gradient alone when the taps' are not asked for; the taps'
    partial sums added in a fixed order, so two calls are bit-equal."""
    _, _, trunk, tg, tb = _head_inputs(batch, 2, cuda, cells=cells)
    g = torch.randn((batch, 48) + cells, generator=torch.Generator(device=cuda).manual_seed(batch), device=cuda)
    want = rt.rgb_beta_tail_backward_reference(g, trunk, tg, tb)
    got = rt._launch_bwd(g, trunk, tg, tb)
    torch.cuda.synchronize()
    for what, a, b in zip(("dtrunk", "dtg", "dtb"), got, want):
        _assert_close_of_largest(a, b, what)
    assert all(torch.equal(a, b) for a, b in zip(rt._launch_bwd(g, trunk, tg, tb), got))
    only = rt._launch_bwd(g, trunk, tg, tb, need_taps=False)
    assert only[1:] == (None, None) and torch.equal(only[0], got[0])
    leaves = [t.clone().requires_grad_(i == 0) for i, t in enumerate((trunk, tg, tb))]
    before = (rt.rgb_beta_tail.launches_bwd, rt.rgb_beta_tail.launches_bwd_bf16)
    (dtrunk,) = torch.autograd.grad(rt.rgb_beta_tail(*leaves), leaves[0], g)
    assert (rt.rgb_beta_tail.launches_bwd, rt.rgb_beta_tail.launches_bwd_bf16) == (before[0] + 1, before[1])
    assert torch.equal(dtrunk, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,trunk_dtype", [(1, BF16), (16, BF16), (128, BF16), (1, torch.float32),
                                               (16, torch.float32)])
def test_bf16_rgb_beta_tail_backward_kernels_match_plain_and_the_vjp(cuda, batch, trunk_dtype):
    """The bf16 form over a bf16 trunk (the hybrid head's) and over a float32
    one (the fused head's): within 4 bf16 steps of its plain version and of
    the bf16 VJP, dtrunk in the trunk's dtype."""
    _, _, trunk, tg, tb = _head_inputs(batch, 2, cuda)
    trunk, tg, tb = trunk.to(trunk_dtype), tg.to(BF16), tb.to(BF16)
    g = torch.randn((batch, 48, 16, 16), generator=torch.Generator(device=cuda).manual_seed(7), device=cuda).to(BF16)
    got = rt._launch_bwd(g, trunk, tg, tb)
    torch.cuda.synchronize()
    leaves = [t.clone().requires_grad_(True) for t in (trunk, tg, tb)]
    vjp = torch.autograd.grad(rt.rgb_beta_tail_reference(*leaves), leaves, g)
    for a, b, c in zip(got, rt.rgb_beta_tail_backward_reference(g, trunk, tg, tb), vjp):
        assert a.dtype == b.dtype == c.dtype
        for want in (b, c):
            _within_bf16_steps(a.to(BF16) if a.dtype != BF16 else a, want.to(BF16), points=4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,channels,dtype", [(1, 64, torch.float32), (8, 64, torch.float32),
                                                  (1, 128, torch.float32), (2, 7, torch.float32),
                                                  (1, 64, BF16), (8, 64, BF16), (1, 128, BF16)])
def test_rgb_beta_head_backward_kernels_match_plain(cuda, batch, channels, dtype):
    """x's gradient through the head's backward kernels (counted once in
    `launches_bwd` / `launches_bwd_bf16`) against
    `rgb_beta_head_backward_reference` on the forward's own trunk: float32 at
    rtol 1e-3 / atol 1e-4 of the largest, bf16 within 4 steps of it and of
    the bf16 VJP."""
    x, tr, _, tg, tb = (t.to(dtype) for t in _head_inputs(batch, channels, cuda))
    g = 4 * torch.randn((batch, 3, 64, 64), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    g = g.to(dtype)  # dx has a std near 0.3, above _within_bf16_steps' floor at C = 128
    xg = x.clone().requires_grad_(True)
    out = rh.rgb_beta_head(xg, tr, tg, tb, HEAD_SCALES)
    trunk = out.grad_fn.saved_tensors[4]
    attr = "launches_bwd_bf16" if dtype == BF16 else "launches_bwd"
    before = getattr(rh.rgb_beta_head, attr)
    (got,) = torch.autograd.grad(out, xg, g)
    torch.cuda.synchronize()
    assert getattr(rh.rgb_beta_head, attr) == before + 1 and trunk.dtype == torch.float32
    want = rh.rgb_beta_head_backward_reference(g, trunk, tr, tg, tb, HEAD_SCALES)
    if dtype == BF16:
        (vjp,) = torch.autograd.grad(rh.rgb_beta_head_reference(xg, tr, tg, tb, HEAD_SCALES), xg, g)
        _within_bf16_steps(got, want, points=4)
        _within_bf16_steps(got, vjp, points=4)
    else:
        _assert_close_of_largest(got, want, "dx")
