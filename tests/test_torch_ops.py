"""npe_tpu_torch's ops against npe_tpu's on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

import torch_parity as tp
from npe_tpu import api as japi
from npe_tpu.ops import activations as jact
from npe_tpu.ops import conv as jconv
from npe_tpu.ops import filters as jfilters
from npe_tpu.ops import linear as jlinear
from npe_tpu.ops import norm as jnorm
from npe_tpu.utils import ranges as jranges
from npe_tpu_torch import api as tapi
from npe_tpu_torch.ops import activations as tact
from npe_tpu_torch.ops import conv as tconv
from npe_tpu_torch.ops import filters as tfilters
from npe_tpu_torch.ops import initializers as tinit
from npe_tpu_torch.ops import linear as tlinear
from npe_tpu_torch.ops import norm as tnorm
from npe_tpu_torch.utils import ranges as tranges
from npe_tpu_torch.utils.checkpoints import from_reference

tp.torch_threads()


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def test_enc_conv_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    w = rng.randn(5, 5, 4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    want = np.asarray(jconv.enc_conv2d(jnp.asarray(x), jnp.asarray(w), b=jnp.asarray(b)))
    v = from_reference({"enc_conv1.W": w, "enc_conv1.b": b}, "cpu")
    got = tconv.enc_conv2d(_nchw(x), v["enc_conv1.W"], v["enc_conv1.b"])
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("mode", ["split", "block", "lhs"])
def test_deconv_matches_jax(mode):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 4, 6).astype(np.float32)
    w = rng.randn(5, 5, 6, 3).astype(np.float32)
    want = np.asarray(jconv.deconv2d_phased(jnp.asarray(x), jnp.asarray(w), mode=mode))
    v = from_reference({"dec_conv1.W": w}, "cpu")
    got = tconv.deconv2d(_nchw(x), v["dec_conv1.W"])
    assert got.shape == (2, 3, 8, 8)
    tp.assert_close(tp.nhwc(got), want)


def test_dense_flattens_maps_in_hwc_order():
    """npe_tpu's dense rows follow the NHWC flatten; the port's NCHW maps
    must meet the same rows without any permutation of the weights."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 4, 5).astype(np.float32)
    w = rng.randn(80, 7).astype(np.float32)
    want = np.asarray(jlinear.dense(jnp.asarray(x), jnp.asarray(w)))
    tp.assert_close(tlinear.dense(_nchw(x), torch.from_numpy(w)).numpy(), want)
    x2 = rng.randn(3, 80).astype(np.float32)
    tp.assert_close(
        tlinear.dense(torch.from_numpy(x2), torch.from_numpy(w)).numpy(),
        np.asarray(jlinear.dense(jnp.asarray(x2), jnp.asarray(w))),
    )


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("ndim", [2, 4])
def test_batch_norm_matches_jax(train, ndim):
    rng = np.random.RandomState(3)
    shape = (4, 3, 3, 5) if ndim == 4 else (6, 5)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    beta, gamma, mean = (rng.randn(5).astype(np.float32) for _ in range(3))
    inv_std = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    jy, (jm, js) = jnorm.batch_norm_apply(jnp.asarray(x), beta, gamma, mean, inv_std, train)
    xt = _nchw(x) if ndim == 4 else torch.from_numpy(x)
    ty, (tm, ts) = tnorm.batch_norm_apply(
        xt, *(torch.from_numpy(a) for a in (beta, gamma, mean, inv_std)), train
    )
    tp.assert_close(tp.nhwc(ty) if ndim == 4 else ty.numpy(), np.asarray(jy))
    tp.assert_close(tm.numpy(), np.asarray(jm))
    tp.assert_close(ts.numpy(), np.asarray(js))
    if train:  # the running stats really moved, by the EMA on inv_std
        assert not np.allclose(ts.numpy(), inv_std)


@pytest.mark.parametrize("sigma", [0.7, 1.5])
def test_gaussian_blur_matches_jax_and_scipy(sigma):
    rng = np.random.RandomState(4)
    img = rng.rand(64, 64).astype(np.float32)
    got = tfilters.gaussian_blur_2d(torch.from_numpy(img), sigma).numpy()
    tp.assert_close(got, np.asarray(jfilters.gaussian_blur_2d(jnp.asarray(img), sigma)))
    tp.assert_close(got, scipy.ndimage.gaussian_filter(img, sigma, mode="reflect"))
    k, r = tfilters.gaussian_kernel_1d(sigma)
    jk, jr = jfilters.gaussian_kernel_1d(sigma)
    assert r == jr
    np.testing.assert_array_equal(k, jk)  # the same numpy arithmetic: exact


def test_patch_masks_match_jax():
    box = (10, 12, 20, 22)
    hard = tapi.patch_mask(64, 64, *box).numpy()
    np.testing.assert_array_equal(hard, np.asarray(japi.patch_mask(64, 64, *box)))
    # sigma == 0 is the hard box exactly, not exp() of a tiny sigma
    np.testing.assert_array_equal(tapi.soft_patch_mask(64, 64, *box, 0.0).numpy(), hard)
    soft = tapi.soft_patch_mask(64, 64, *box, 1.5).numpy()
    tp.assert_close(soft, np.asarray(japi.soft_patch_mask(64, 64, *box, 1.5)))
    assert np.allclose(soft[12:22, 10:20], 1.0) and 0 < soft[12, 5] < soft[12, 9] < 1.0


def test_activations_and_ranges_match_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(100) * 3).astype(np.float32)
    t = torch.from_numpy(x)
    tp.assert_close(tact.lrelu(0.2)(t).numpy(), np.asarray(jact.lrelu(0.2)(jnp.asarray(x))))
    tp.assert_close(tact.relu(t).numpy(), np.asarray(jact.relu(jnp.asarray(x))))
    tp.assert_close(tact.elu(t).numpy(), np.asarray(jact.elu(jnp.asarray(x))))
    u8 = rng.randint(0, 256, 50).astype(np.float32)
    np.testing.assert_allclose(tranges.to_tanh(torch.from_numpy(u8)).numpy(), jranges.to_tanh(u8), atol=1e-6)
    np.testing.assert_allclose(tranges.from_tanh(tranges.to_tanh(u8)), u8, atol=1e-4)


def test_initializers_distributions():
    """The port draws from a torch.Generator: npe_tpu's distributions, not
    its values. 200k draws put the sample mean within ~5 sigma of 0 at
    5 * 0.02 / sqrt(2e5) = 2.2e-4."""
    gen = torch.Generator().manual_seed(0)
    w = tinit.normal(0.02)(gen, (200, 1000), "cpu")
    assert w.dtype == torch.float32 and w.shape == (200, 1000)
    assert abs(float(w.mean())) < 2.5e-4
    assert abs(float(w.std()) - 0.02) < 2e-4
    again = tinit.normal(0.02)(torch.Generator().manual_seed(0), (200, 1000), "cpu")
    assert torch.equal(w, again)  # seeded: reproducible
    c = tinit.constant(-1.0)(gen, (3, 4), "cpu")
    assert torch.equal(c, torch.full((3, 4), -1.0))
