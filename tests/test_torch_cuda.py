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
from npe_tpu_torch.ops.kernels import rgb_beta_head as rh
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain

TINY = str(pathlib.Path(__file__).resolve().parent / "tiny_ian_torch.py")
TINY_V1 = str(pathlib.Path(__file__).resolve().parent / "tiny_ianv1_torch.py")


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
@pytest.mark.parametrize("sigma", [0.7, 1.5])
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


def _head_inputs(batch, c, device, seed=6):
    """Seeded O(1) features and tap matrices at unit gain."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, c, 64, 64).astype(np.float32)
    tr = (rng.randn(9, 16 * c, 96) / np.sqrt(9 * 16 * c)).astype(np.float32)
    trunk = rng.randn(batch, 96, 16, 16).astype(np.float32)
    tg = (rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)
    tb = (rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, tr, trunk, tg, tb)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_rgb_beta_tail_kernel_matches_plain(cuda, batch):
    _, _, trunk, tg, tb = _head_inputs(batch, 2, cuda)
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
@pytest.mark.parametrize("batch,channels", [(1, 64), (8, 64), (1, 8), (3, 8)])
def test_rgb_beta_head_kernel_matches_plain(cuda, batch, channels):
    x, tr, _, tg, tb = _head_inputs(batch, channels, cuda)
    before = rh.rgb_beta_head.launches
    got = rh.rgb_beta_head(x, tr, tg, tb)
    torch.cuda.synchronize()
    assert rh.rgb_beta_head.launches == before + 1
    want = rh.rgb_beta_head_reference_packed(x, tr, tg, tb)
    assert got.shape == (batch, 3, 64, 64) and float(want.std()) > 0.1
    # the trunk sums 9 * 16 * C terms in another order than cuDNN does
    assert float((got - want).abs().max()) <= 5e-5
    xg = x.clone().requires_grad_(True)
    (got_g,) = torch.autograd.grad((rh.rgb_beta_head(xg, tr, tg, tb) ** 2).sum(), xg)
    (want_g,) = torch.autograd.grad((rh.rgb_beta_head_reference_packed(xg, tr, tg, tb) ** 2).sum(), xg)
    torch.testing.assert_close(got_g, want_g, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_wrappers_raise_on_the_card_too(cuda):
    x, tr, trunk, tg, tb = _head_inputs(1, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rt.rgb_beta_tail(trunk.transpose(2, 3), tg, tb)
    with pytest.raises(ValueError, match="is on"):
        rt.rgb_beta_tail(trunk, tg.cpu(), tb)
    with pytest.raises(TypeError, match="float32"):
        rh.rgb_beta_head(x.half(), tr, tg, tb)


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
