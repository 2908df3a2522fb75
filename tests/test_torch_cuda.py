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
from npe_tpu_torch.ops.kernels import edit_tail as et

TINY = str(pathlib.Path(__file__).resolve().parent / "tiny_ian_torch.py")


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
