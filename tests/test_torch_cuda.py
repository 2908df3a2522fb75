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
    # full IAN's three blocks at batch 1 (8x8x512 takes the most slices, 64), 8 and 128 (one slice)
    (1, 512, 8, (0, 2)), (1, 256, 16, (0, 2, 3)), (1, 128, 32, (0, 2, 3)),
    (8, 512, 8, (0, 2)), (8, 256, 16, (0, 2, 3)), (8, 128, 32, (0, 2, 3)),
    (128, 512, 8, (0, 2)), (128, 256, 16, (0, 2, 3)), (128, 128, 32, (0, 2, 3)),
    (2, 16, 8, (0, 2)), (3, 32, 16, (0, 2, 3)),  # the tiny profile's widths
    (3, 80, 16, (2, 3, 4)),  # a channel tile that is only part full; no scale 0
    (600, 64, 8, (0,)),  # more blocks than one wave: one slice, the epilogue in the product kernel
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
    xg = x.clone().requires_grad_(True)
    (got_g,) = torch.autograd.grad((mk.mdblock_fused(xg, t1, t2, aff, scales) ** 2).sum(), xg)
    (want_g,) = torch.autograd.grad((mk.mdblock_taps_reference(xg, t1, t2, aff, scales) ** 2).sum(), xg)
    torch.testing.assert_close(got_g, want_g, rtol=1e-3, atol=1e-4 * float(want_g.abs().max()))


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
    launches the tail's bf16 form, whose backward is its plain version's VJP
    in bf16; no float32 tail, no head or MDBLOCK kernel. Masters stay
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
              (mk.mdblock_fused, "launches_bf16")]
    metrics = []
    for device in (cuda, "cpu"):
        state = ts.init_train_state(module, {k: v.to(device) for k, v in variables.items()}, cfg)
        gen_step, discrim_step = ts.make_train_steps(module, cfg)
        before = [getattr(fn, attr) for fn, attr in counts]
        batch = [t.to(device) for t in (x, z, eps)]
        state, m_g = gen_step(state, *batch, 2e-4)
        state, m_d = discrim_step(state, *batch, 2e-4)
        launched = [getattr(fn, attr) - b for (fn, attr), b in zip(counts, before)]
        assert launched == ([0, 4, 0, 0, 0, 0] if device is cuda else [0] * 6), launched
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
