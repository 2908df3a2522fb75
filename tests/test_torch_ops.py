"""npe_tpu_torch's ops against npe_tpu's on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

import torch_parity as tp
from npe_tpu import api as japi
from npe_tpu.ops import activations as jact
from npe_tpu.ops import beta as jbeta
from npe_tpu.ops import conv as jconv
from npe_tpu.ops import filters as jfilters
from npe_tpu.ops import linear as jlinear
from npe_tpu.ops import mdcl as jmdcl
from npe_tpu.ops import norm as jnorm
from npe_tpu.utils import ranges as jranges
from npe_tpu_torch import api as tapi
from npe_tpu_torch.ops import activations as tact
from npe_tpu_torch.ops import beta as tbeta
from npe_tpu_torch.ops import conv as tconv
from npe_tpu_torch.ops import filters as tfilters
from npe_tpu_torch.ops import initializers as tinit
from npe_tpu_torch.ops import linear as tlinear
from npe_tpu_torch.ops import mdcl as tmdcl
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
    tp.assert_close(tact.sigmoid(t).numpy(), np.asarray(jact.sigmoid(jnp.asarray(x))))
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


def test_orthogonal_is_orthogonal():
    gen = torch.Generator().manual_seed(1)
    tall = tinit.orthogonal()(gen, (40, 24), "cpu")
    tp.assert_close((tall.T @ tall).numpy(), np.eye(24), atol=1e-5)
    wide = tinit.orthogonal("relu")(gen, (24, 40), "cpu")  # gain sqrt(2)
    tp.assert_close((wide @ wide.T).numpy(), 2.0 * np.eye(24), atol=1e-5)
    conv = tinit.orthogonal()(gen, (8, 4, 3, 3), "cpu")  # flattened past dim 0
    assert conv.shape == (8, 4, 3, 3) and conv.dtype == torch.float32
    tp.assert_close((conv.reshape(8, -1) @ conv.reshape(8, -1).T).numpy(), np.eye(8), atol=1e-5)
    again = tinit.orthogonal()(torch.Generator().manual_seed(1), (40, 24), "cpu")
    assert torch.equal(tall, again)
    with pytest.raises(ValueError, match=">=2 dims"):
        tinit.orthogonal()(gen, (5,), "cpu")


def test_beta_mean_matches_jax():
    rng = np.random.RandomState(6)
    a, b = (rng.uniform(0, 1, (3, 7)).astype(np.float32) for _ in range(2))
    a[0, 0] = b[0, 0] = 0.0  # the 1e-8 keeps 0 / 0 finite: the mean is -1
    got = tbeta.beta_mean(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    tp.assert_close(got, np.asarray(jbeta.beta_mean(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6, atol=1e-6)
    assert got[0, 0] == -1.0 and np.isfinite(got).all()


@pytest.mark.parametrize("padding,dilation", [(0, 1), (2, 1), (3, 3)])
def test_conv2d_matches_jax(padding, dilation):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 9, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), padding=padding, rhs_dilation=dilation, b=b))
    got = tconv.conv2d(_nchw(x), tp.oihw(w), torch.from_numpy(b), padding=padding, dilation=dilation)
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_round_trip_and_matches_jax(r):
    """The port packs component-major (c*rr + pos), npe_tpu position-major
    (pos*C + c): equal after the layout helper's reordering."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 12, 3).astype(np.float32)
    packed = tconv.space_to_depth(_nchw(x), r)
    assert packed.shape == (2, 3 * r * r, 8 // r, 12 // r)
    assert torch.equal(tconv.depth_to_space(packed, r), _nchw(x))
    want = np.asarray(jconv.space_to_depth(jnp.asarray(x), r))
    np.testing.assert_array_equal(tp.position_major(tp.nhwc(packed), r * r), want)
    np.testing.assert_array_equal(tp.component_major(want, r * r), tp.nhwc(packed))
    # channel c*rr + p*r + q holds pixel offset (p, q) of channel c
    c, p, q = 1, r - 1, 1
    assert torch.equal(packed[:, c * r * r + p * r + q], _nchw(x)[:, c, p::r, q::r])
    back = np.asarray(jconv.depth_to_space(jnp.asarray(want), r))
    np.testing.assert_array_equal(tp.nhwc(tconv.depth_to_space(packed, r)), back)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("ksize", [3, 5, 9])
def test_pack_kernel_s2d_conv_equals_the_dense_conv(ksize, r):
    rng = np.random.RandomState(ksize * 10 + r)
    x = torch.from_numpy(rng.randn(2, 3, 16, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(5, 3, ksize, ksize).astype(np.float32))
    t = tconv.s2d_block_taps(ksize, r)
    assert t == jconv.s2d_block_taps(ksize, r)
    kp = tconv.pack_kernel_s2d(k, r)
    assert kp.shape == (5 * r * r, 3 * r * r, t, t)
    dense = tconv.conv2d(x, k, padding=ksize // 2)
    packed = tconv.conv2d(tconv.space_to_depth(x, r), kp, padding=t // 2)
    tp.assert_close(tconv.depth_to_space(packed, r).numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)
    # and it is npe_tpu's packed kernel, reordered on both channel axes
    want = np.asarray(jconv.pack_kernel_s2d(jnp.asarray(tp.hwio(k)), r))
    got = tp.position_major(tp.position_major(tp.hwio(kp), r * r, axis=2), r * r, axis=3)
    np.testing.assert_array_equal(got, want)


def test_pack_kernel_s2d_carries_gradients_to_the_dense_kernel():
    k = torch.randn(2, 3, 9, 9, generator=torch.Generator().manual_seed(0), requires_grad=True)
    (g,) = torch.autograd.grad(tconv.pack_kernel_s2d(k, 4).sum(), k)
    # each dense tap lands in exactly one packed tap for each of the 16 output offsets
    assert torch.equal(g, torch.full_like(g, 16.0))


@pytest.mark.parametrize("scales", [[2, 3, 4], [0, 2], [0, 2, 3], [1, 2]])
def test_compose_mdcl_kernel_and_mdcl_apply_match_jax(scales):
    rng = np.random.RandomState(sum(scales))
    w = rng.randn(3, 3, 4, 5).astype(np.float32)
    base = rng.randn(5).astype(np.float32)
    coeffs = {s: rng.randn(5).astype(np.float32) for s in scales}
    size = tmdcl.mdcl_kernel_size(scales)
    assert size == jmdcl.mdcl_kernel_size(scales)
    want = np.asarray(jmdcl.compose_mdcl_kernel(jnp.asarray(w), base, coeffs, scales))
    tcoeffs = {s: torch.from_numpy(c) for s, c in coeffs.items()}
    got = tmdcl.compose_mdcl_kernel(tp.oihw(w), torch.from_numpy(base), tcoeffs, scales)
    assert got.shape == (5, 4, size, size)
    tp.assert_close(tp.hwio(got), want, rtol=1e-5, atol=1e-6)
    x = rng.randn(2, 12, 12, 4).astype(np.float32)
    for mode in ("fused", "branch"):
        want = np.asarray(jmdcl.mdcl_apply(jnp.asarray(x), jnp.asarray(w), base, coeffs, scales, mode=mode))
        got = tmdcl.mdcl_apply(_nchw(x), tp.oihw(w), torch.from_numpy(base), tcoeffs, scales)
        tp.assert_close(tp.nhwc(got), want)


# --- the training slice's ops ---------------------------------------------------


@pytest.mark.parametrize("n,feat,kernels,dims", [(4, 128, 32, 5), (7, 16, 500, 5), (1, 8, 4, 3)])
def test_minibatch_discrimination_matches_jax(n, feat, kernels, dims):
    from npe_tpu.ops import minibatch as jmb
    from npe_tpu_torch.ops import minibatch as tmb

    rng = np.random.RandomState(n)
    x = rng.randn(n, feat).astype(np.float32)
    theta = (rng.randn(feat, kernels, dims) * 0.05).astype(np.float32)
    lws = (rng.randn(kernels, dims) * 0.1).astype(np.float32)
    b = rng.randn(kernels).astype(np.float32)
    want = np.asarray(jmb.minibatch_discrimination(x, theta, lws, b))
    got = tmb.minibatch_discrimination(*(torch.from_numpy(a) for a in (x, theta, lws, b)))
    assert tuple(got.shape) == want.shape == (n, feat + kernels)
    tp.assert_close(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # a 4-D input flattens; the self term contributes exp(-1e6) = 0
    got4 = tmb.minibatch_discrimination(torch.from_numpy(x).reshape(n, feat, 1, 1),
                                        *(torch.from_numpy(a) for a in (theta, lws, b)))
    assert torch.equal(got4, got)
    if n == 1:
        tp.assert_close(got[:, feat:].numpy(), b[None], rtol=0, atol=1e-6)


def test_global_avg_pool_matches_jax():
    x = np.random.RandomState(0).randn(3, 4, 5, 6).astype(np.float32)  # NHWC
    tp.assert_close(tconv.global_avg_pool(_nchw(x)).numpy(), np.asarray(jconv.global_avg_pool(x)), rtol=1e-5,
                    atol=1e-6)


def test_gaussian_sample_takes_its_noise_as_an_argument():
    import jax

    from npe_tpu.ops import sampling as jsampling
    from npe_tpu_torch.ops import sampling as tsampling

    rng = np.random.RandomState(1)
    mu, ls = (rng.randn(4, 16).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, mu.shape, jnp.float32))
    want = np.asarray(jsampling.gaussian_sample(mu, ls, key))
    tmu, tls = torch.from_numpy(mu), torch.from_numpy(ls)
    tp.assert_close(tsampling.gaussian_sample(tmu, tls, torch.from_numpy(eps)).numpy(), want, rtol=1e-5, atol=1e-6)
    assert tsampling.gaussian_sample(tmu, tls, None) is tmu  # deterministic=True
    assert jsampling.gaussian_sample(mu, ls, None) is mu
    a = tsampling.gaussian_sample(tmu, tls, torch.Generator().manual_seed(3))
    b = tsampling.gaussian_sample(tmu, tls, torch.Generator().manual_seed(3))
    c = tsampling.gaussian_sample(tmu, tls, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, tmu)
    with pytest.raises(ValueError, match="noise"):
        tsampling.gaussian_sample(tmu, tls, torch.zeros(4, 8))
    assert tsampling.gaussian_sample_spatial is tsampling.gaussian_sample
    outs = tsampling.gaussian_sample_list([tmu, tmu], [tls, tls], [torch.from_numpy(eps), torch.zeros(4, 16)])
    tp.assert_close(outs[0].numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(outs[1], tmu)
    assert tsampling.gaussian_sample_list([tmu], [tls], None)[0] is tmu
