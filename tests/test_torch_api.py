"""npe_tpu_torch.api.IAN against npe_tpu.api.IAN on the same variables, at
the tiny widths of tests/tiny_ian.py (IAN_simple) and tests/tiny_ianv1.py
(IANv1: the IAF on encode, the RGB-Beta head on decode)."""

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


@pytest.fixture(scope="module")
def v1_models():
    jian = JaxIAN(config_path=tp.TINY_V1_JAX, variables=tp.jax_variables(tp.TINY_V1_JAX))
    tian = TorchIAN(
        config_path=tp.TINY_V1_TORCH, variables=tp.port_variables(tp.TINY_V1_JAX), device="cpu"
    )
    return jian, tian


def test_ianv1_encode_images_and_sample_at(v1_models):
    jian, tian = v1_models
    x = np.random.RandomState(2).uniform(-1, 1, (3, 3, 64, 64)).astype(np.float32)
    z = tian.encode_images(x)
    assert z.shape == (3, 16) and z.dtype == np.float32
    tp.assert_close(z, jian.encode_images(x))  # through the IAF
    img = tian.sample_at(z)
    assert img.shape == (3, 3, 64, 64) and img.std() > 0.1
    tp.assert_close(img, jian.sample_at(z))
    assert tian.get_zdim() == jian.get_zdim() == 16


@pytest.mark.parametrize("box", [(10, 12, 20, 22), (0, 0, 64, 64)])
def test_ianv1_imgrad_and_imgrad_rgb(v1_models, box):
    """The gradients go through the head's backward (the plain version's)."""
    jian, tian = v1_models
    rng = np.random.RandomState(3)
    z = rng.randn(1, 16).astype(np.float32)
    tp.assert_close(tian.imgrad(*box, z), jian.imgrad(*box, z))
    rgb = np.broadcast_to(rng.uniform(-1, 1, (1, 3, 1, 1)), (1, 3, 64, 64)).astype(np.float32)
    g_rgb = tian.imgradRGB(*box, rgb, z)
    assert g_rgb.shape == (1, 16) and np.abs(g_rgb).max() > 1e-3
    tp.assert_close(g_rgb, jian.imgradRGB(*box, rgb, z))


@pytest.mark.parametrize("head_mode", ["plain", "hybrid", "fused"])
def test_ianv1_head_mode_reaches_every_decode(v1_models, head_mode):
    """`head_mode` only picks the head's formulation, for sample_at and for
    the gradients alike; a model without the head refuses it."""
    jian, default = v1_models
    tian = TorchIAN(config_path=tp.TINY_V1_TORCH, variables=default.variables, device="cpu", head_mode=head_mode)
    z = np.random.RandomState(4).randn(2, 16).astype(np.float32)
    tp.assert_close(tian.sample_at(z), jian.sample_at(z))
    tp.assert_close(tian.imgrad(8, 8, 24, 24, z[:1]), jian.imgrad(8, 8, 24, 24, z[:1]))
    with pytest.raises(TypeError, match="head_mode"):
        TorchIAN(config_path=tp.TINY_TORCH, device="cpu", head_mode=head_mode).sample_at(np.zeros((1, 16), np.float32))


def test_ianv1_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchIAN(config_path="IANv1")
