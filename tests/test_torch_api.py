"""npe_tpu_torch.api.IAN against npe_tpu.api.IAN on the same variables, at
the tiny widths of tests/tiny_ian.py."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.api import IAN as JaxIAN
from npe_tpu_torch.api import IAN as TorchIAN

tp.torch_threads()


@pytest.fixture(scope="module")
def models():
    jian = JaxIAN(config_path=tp.TINY_JAX, variables=tp.jax_variables(tp.TINY_JAX))
    tian = TorchIAN(
        config_path=tp.TINY_TORCH, variables=tp.port_variables(tp.TINY_JAX), device="cpu"
    )
    return jian, tian


def test_encode_images_and_sample_at(models):
    jian, tian = models
    x = np.random.RandomState(0).uniform(-1, 1, (3, 3, 64, 64)).astype(np.float32)
    z = tian.encode_images(x)
    assert z.shape == (3, 16) and z.dtype == np.float32
    tp.assert_close(z, jian.encode_images(x))
    img = tian.sample_at(z)
    assert img.shape == (3, 3, 64, 64)
    tp.assert_close(img, jian.sample_at(z))
    assert tian.get_zdim() == jian.get_zdim() == 16


@pytest.mark.parametrize("box", [(10, 12, 20, 22), (0, 0, 64, 64)])
def test_imgrad_and_imgrad_rgb(models, box):
    jian, tian = models
    rng = np.random.RandomState(1)
    z = rng.randn(1, 16).astype(np.float32)
    g = tian.imgrad(*box, z)
    assert g.shape == (1, 16)
    tp.assert_close(g, jian.imgrad(*box, z))
    rgb = np.broadcast_to(rng.uniform(-1, 1, (1, 3, 1, 1)), (1, 3, 64, 64)).astype(np.float32)
    g_rgb = tian.imgradRGB(*box, rgb, z)
    tp.assert_close(g_rgb, jian.imgradRGB(*box, rgb, z))
    assert np.abs(g_rgb).max() > 1e-3  # a real gradient, not a vacuous match


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchIAN(config_path=tp.TINY_TORCH)
