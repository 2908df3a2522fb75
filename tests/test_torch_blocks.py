"""npe_tpu_torch's library-extra blocks and the ops they need (conv with a
stride, dilated conv, pooling, upscale, batch renorm, mdclW, the subpixel
shuffle) against npe_tpu's on the same numpy-seeded inputs, mirroring
tests/test_blocks.py, tests/test_ops.py:41-101 and tests/test_mdcl.py:79-93.
Values at the golden tolerance (rtol 1e-3 / atol 1e-4); gradients in float64
in both packages, to 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.models.common import VarBuilder as JaxVarBuilder
from npe_tpu.ops import activations as jact
from npe_tpu.ops import blocks as jblocks
from npe_tpu.ops import conv as jconv
from npe_tpu.ops import mdcl as jmdcl
from npe_tpu.ops import norm as jnorm
from npe_tpu_torch.models.common import VarBuilder
from npe_tpu_torch.ops import activations as tact
from npe_tpu_torch.ops import blocks as tblocks
from npe_tpu_torch.ops import conv as tconv
from npe_tpu_torch.ops import mdcl as tmdcl
from npe_tpu_torch.ops import norm as tnorm
from npe_tpu_torch.utils.checkpoints import from_reference

tp.torch_threads()


def _x(shape, seed=1, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _jax_block(init, apply, scales, x, seed=0, **kw):
    vb = JaxVarBuilder(jax.random.PRNGKey(seed))
    init(vb, "blk", x.shape[-1], 4, scales)
    return vb.v, np.asarray(apply(vb.v, "blk", jnp.asarray(x), scales, **kw))


@pytest.mark.parametrize("scales", [[0, 2], [2, 3], [0, 2, 3]])
def test_usl_matches_jax(scales):
    x = _x((2, 8, 8, 6))
    v, want = _jax_block(jblocks.usl_init, jblocks.usl_apply, scales, x)
    got = tblocks.usl_apply(from_reference(v, "cpu"), "blk", tp.nchw(x), scales)
    assert got.shape == (2, 4, 16, 16)
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("scales", [[0, 2], [2, 3], [0, 2, 3]])
def test_dsl_matches_jax(scales):
    x = _x((2, 8, 8, 6))
    v, want = _jax_block(jblocks.dsl_init, jblocks.dsl_apply, scales, x)
    got = tblocks.dsl_apply(from_reference(v, "cpu"), "blk", tp.nchw(x), scales)
    assert got.shape == (2, 4, 4, 4)
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("block", ["usl", "dsl"])
def test_block_gradients_match_jax_in_float64(block):
    scales = [0, 2]
    init, apply = (jblocks.usl_init, jblocks.usl_apply) if block == "usl" else (jblocks.dsl_init, jblocks.dsl_apply)
    with tp.x64():
        vb = JaxVarBuilder(jax.random.PRNGKey(0))
        init(vb, "blk", 6, 4, scales)
        v = {k: np.asarray(a, np.float64) for k, a in vb.v.items()}
        x = _x((2, 8, 8, 6), dtype=np.float64)
        gx, gv = jax.grad(lambda xx, vv: jnp.sum(apply(vv, "blk", xx, scales) ** 2), argnums=(0, 1))(
            jnp.asarray(x), {k: jnp.asarray(a) for k, a in v.items()})
    tv = {k: t.requires_grad_(True) for k, t in from_reference(v, "cpu").items()}
    tx = tp.nchw(x).requires_grad_(True)
    (getattr(tblocks, f"{block}_apply")(tv, "blk", tx, scales) ** 2).sum().backward()
    np.testing.assert_allclose(tp.nhwc(tx.grad), np.asarray(gx), rtol=1e-7, atol=1e-9)
    got = {k: t.grad for k, t in tv.items()}
    from npe_tpu_torch.utils.checkpoints import to_reference

    tp.assert_grads_close(to_reference(got), {k: np.asarray(a) for k, a in gv.items()}, rtol=1e-7,
                          atol_of_largest=1e-9, floor=1e-12)


def test_res_layer_and_pd_mirror_npe_tpu():
    out = tblocks.res_layer(torch.tensor([-1.0, 2.0]), torch.tensor([0.5, -3.0]), tact.relu)
    np.testing.assert_allclose(out.numpy(), [0.0, 0.0])
    d = tblocks.pd(num_layers=3, num_filters=[8, 8, 16], filter_size=3)
    want = jblocks.pd(num_layers=3, num_filters=[8, 8, 16], filter_size=3)
    assert {k: v for k, v in d.items() if k != "nonlinearity"} == {k: v for k, v in want.items()
                                                                   if k != "nonlinearity"}
    assert d["nonlinearity"] == [tact.elu] * 3


def _inception_dicts(jax_side, upscale=False):
    """Five branches (conv, 1x1 conv, dilated conv, max and average pools);
    upscaling, four that each double the map (the dilated conv does not)."""
    act = jact if jax_side else tact
    up = 2 if upscale else 1
    dicts = [
        dict(num_layers=2, num_filters=8, filter_size=3, pad=1, stride=[up, 1], bnorm=1, nonlinearity=act.elu),
        dict(num_layers=1, num_filters=4, filter_size=1, pad=0, stride=up, bnorm=0, nonlinearity=act.relu),
        dict(num_layers=1, num_filters=6, filter_size=3, pad=1, stride=up, bnorm=0, style="pool", mode="max",
             nonlinearity=None),
        dict(num_layers=1, num_filters=6, filter_size=3, pad=1, stride=up, bnorm=0, style="pool", nonlinearity=None),
    ]
    if not upscale:
        dicts.append(dict(num_layers=1, num_filters=4, filter_size=3, pad=1, stride=1, bnorm=1, style="dilation",
                          dilation=2, nonlinearity=None))
    pd = jblocks.pd if jax_side else tblocks.pd
    return [pd(**d) for d in dicts]


@pytest.mark.parametrize("upscale", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_inception_block_matches_jax(train, upscale):
    """Conv (stride-2 deconv when upscaling), a 1x1 conv, a dilated conv
    and max / average pools in five branches, with batch norm; the BN
    updates of the training form too."""
    x = _x((2, 8, 8, 6))
    vb = JaxVarBuilder(jax.random.PRNGKey(0))
    jblocks.inception_init(vb, "inc", 6, _inception_dicts(True, upscale))
    v = tp.with_bn_state(vb.v) if not train else vb.v
    upd_j, upd_t = {}, {}
    want = np.asarray(jblocks.inception_apply(v, upd_j, "inc", jnp.asarray(x), _inception_dicts(True, upscale),
                                              train=train, upscale=upscale))
    got = tblocks.inception_apply(from_reference(v, "cpu"), upd_t, "inc", tp.nchw(x),
                                  _inception_dicts(False, upscale), train=train, upscale=upscale)
    side = 16 if upscale else 8
    assert got.shape == (2, 8 + 4 + 6 + 6 + (0 if upscale else 4), side, side)
    tp.assert_close(tp.nhwc(got), want)
    assert sorted(upd_t) == sorted(upd_j) and (len(upd_t) > 0) == train
    for k, a in upd_j.items():
        tp.assert_close(upd_t[k].numpy(), np.asarray(a))


def test_inception_init_mirrors_npe_tpu_names_and_shapes():
    dicts_j, dicts_t = _inception_dicts(True), _inception_dicts(False)
    vb = JaxVarBuilder(jax.random.PRNGKey(0))
    jblocks.inception_init(vb, "inc", 6, dicts_j)
    tvb = VarBuilder(torch.Generator().manual_seed(0), "cpu")
    tblocks.inception_init(tvb, "inc", 6, dicts_t)
    want = from_reference(vb.v, "cpu")
    assert sorted(tvb.v) == sorted(want)
    assert all(tvb.v[k].shape == want[k].shape for k in want)


# --- the ops the blocks need ---------------------------------------------------


@pytest.mark.parametrize("stride,padding", [(2, 1), (2, "SAME"), (1, "SAME"), (2, "VALID"), (2, ((0, 1), (1, 2)))])
def test_strided_conv2d_matches_jax(stride, padding):
    x, w = _x((2, 9, 9, 4)), _x((3, 3, 4, 5), seed=2)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding))
    got = tconv.conv2d(tp.nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), stride=stride, padding=padding)
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("ksize,dilation", [(3, 2), (3, 3), (2, 2)])
def test_dilated_conv2d_matches_jax(ksize, dilation):
    x, w = _x((2, 10, 10, 3)), _x((ksize, ksize, 3, 4), seed=3)
    want = np.asarray(jconv.dilated_conv2d(jnp.asarray(x), jnp.asarray(w), dilation))
    got = tconv.dilated_conv2d(tp.nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), dilation)
    assert got.shape[2:] == (10, 10)
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("window,stride,padding", [(2, 2, "SAME"), (3, 2, "SAME"), (3, 1, "SAME"), (2, 2, "VALID"),
                                                   (3, 2, 1)])
@pytest.mark.parametrize("pool", ["avg", "max"])
def test_pools_match_jax(pool, window, stride, padding):
    x = _x((2, 9, 9, 3))
    want = np.asarray(getattr(jconv, f"{pool}_pool")(jnp.asarray(x), window, stride, padding=padding))
    got = getattr(tconv, f"{pool}_pool")(tp.nchw(x), window, stride, padding=padding)
    tp.assert_close(tp.nhwc(got), want)


def test_avg_pool_count_include_pad_and_upscale_match_jax():
    x = _x((1, 5, 5, 2))
    want = np.asarray(jconv.avg_pool(jnp.asarray(x), 3, 2, padding="SAME", count_include_pad=True))
    tp.assert_close(tp.nhwc(tconv.avg_pool(tp.nchw(x), 3, 2, padding="SAME", count_include_pad=True)), want)
    np.testing.assert_array_equal(tp.nhwc(tconv.upscale2d(tp.nchw(x), 3)),
                                  np.asarray(jconv.upscale2d(jnp.asarray(x), 3)))


@pytest.mark.parametrize("ksize,stride,crop", [(5, 2, 2), (3, 2, 1), (4, 2, 1)])
def test_deconv2d_geometry_matches_jax(ksize, stride, crop):
    x, w = _x((2, 4, 4, 3)), _x((ksize, ksize, 3, 5), seed=4)
    want = np.asarray(jconv.deconv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, crop=crop))
    got = tconv.deconv2d(tp.nchw(x), torch.from_numpy(w.transpose(2, 3, 0, 1).copy()), stride=stride, crop=crop)
    assert got.shape[2:] == (4 * stride, 4 * stride)
    tp.assert_close(tp.nhwc(got), want)


# --- batch renorm -------------------------------------------------------------


def _renorm_inputs(ndim, seed=0):
    rng = np.random.RandomState(seed)
    shape = (16, 6) if ndim == 2 else (4, 5, 5, 6)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    stats = [rng.randn(6).astype(np.float32) * s + o for s, o in ((0.1, 0.0), (0.1, 1.0), (1.0, 0.0), (0.2, 0.5))]
    return x, stats


def _t(x):
    return tp.nchw(x) if x.ndim == 4 else torch.from_numpy(x)


def _back(t):
    return tp.nhwc(t) if t.ndim == 4 else t.detach().numpy()


@pytest.mark.parametrize("itr", [0, 3000, 10_000])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("ndim", [2, 4])
def test_batch_renorm_matches_jax(ndim, train, itr):
    x, (beta, gamma, mean, istd) = _renorm_inputs(ndim)
    rmax, dmax = jnorm.renorm_schedule(itr)
    y_j, (m_j, s_j) = jnorm.batch_renorm_apply(jnp.asarray(x), *(jnp.asarray(a) for a in (beta, gamma, mean, istd)),
                                               rmax, dmax, train)
    t_rmax, t_dmax = tnorm.renorm_schedule(itr)
    assert (t_rmax, t_dmax) == (float(rmax), float(dmax))
    y, (m, s) = tnorm.batch_renorm_apply(_t(x), *(torch.from_numpy(a) for a in (beta, gamma, mean, istd)),
                                         t_rmax, t_dmax, train)
    tp.assert_close(_back(y), np.asarray(y_j))
    tp.assert_close(m.numpy(), np.asarray(m_j))
    tp.assert_close(s.numpy(), np.asarray(s_j))


def test_renorm_schedule_takes_tensors_and_feeds_renorm_as_plain_bn():
    r, d = tnorm.renorm_schedule(torch.tensor(3000))
    rj, dj = jnorm.renorm_schedule(3000)
    np.testing.assert_allclose([float(r), float(d)], [float(rj), float(dj)], rtol=1e-6)
    x, (beta, gamma, mean, istd) = _renorm_inputs(2, seed=1)
    args = [torch.from_numpy(a) for a in (beta, gamma, mean, istd)]
    y_rn, _ = tnorm.batch_renorm_apply(torch.from_numpy(x), *args, *tnorm.renorm_schedule(0), train=True)
    y_bn, _ = tnorm.batch_norm_apply(torch.from_numpy(x), *args, train=True)
    np.testing.assert_allclose(y_rn.numpy(), y_bn.numpy(), rtol=1e-5, atol=1e-5)


def test_batch_renorm_gradient_matches_jax_in_float64():
    """r and d carry no gradient in either package."""
    x, stats = _renorm_inputs(4, seed=2)
    x = x.astype(np.float64)
    stats = [a.astype(np.float64) for a in stats]
    with tp.x64():
        def f(xx, beta, gamma):
            y, _ = jnorm.batch_renorm_apply(xx, beta, gamma, jnp.asarray(stats[2]), jnp.asarray(stats[3]), 1.5, 0.5,
                                            True)
            return jnp.sum(jnp.sin(y))

        want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(stats[0]), jnp.asarray(stats[1]))
    tx, tb, tg = _t(x).requires_grad_(True), *(torch.from_numpy(a).requires_grad_(True) for a in stats[:2])
    y, _ = tnorm.batch_renorm_apply(tx, tb, tg, torch.from_numpy(stats[2]), torch.from_numpy(stats[3]), 1.5, 0.5, True)
    torch.sin(y).sum().backward()
    for got, w in zip((_back(tx.grad), tb.grad.numpy(), tg.grad.numpy()), want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-7, atol=1e-10)


# --- mdclW and the subpixel shuffle -------------------------------------------


@pytest.mark.parametrize("scales", [[2], [2, 3], [0, 2, 4]])
def test_mdclw_kernel_matches_jax(scales):
    w = _x((3, 3, 4, 5))
    coeffs = {s: _x((5,), seed=10 + s) for s in [1] + [s for s in scales if s > 0]}
    want = np.asarray(jmdcl.mdclw_kernel(jnp.asarray(w), {s: jnp.asarray(c) for s, c in coeffs.items()}, scales))
    got = tmdcl.mdclw_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                             {s: torch.from_numpy(c) for s, c in coeffs.items()}, scales)
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


def test_mdclw_overwrite_semantics():
    """The base filter lands ON TOP of the larger-scale copies
    (`layers.py:147`), as tests/test_mdcl.py:79 checks npe_tpu's."""
    k = tmdcl.mdclw_kernel(torch.ones(1, 1, 3, 3), {1: torch.tensor([2.0]), 2: torch.tensor([3.0])}, [2])
    assert k.shape == (1, 1, 5, 5)
    assert k[0, 0, 2, 2] == 2.0 and k[0, 0, 0, 0] == 3.0 and k[0, 0, 1, 1] == 2.0 and k[0, 0, 0, 1] == 0.0


@pytest.mark.parametrize("r", [2, 3])
def test_subpixel_shuffle_matches_jax_and_its_channel_map(r):
    c = 3
    x = np.arange(2 * 2 * 2 * c * r * r, dtype=np.float32).reshape(2, 2, 2, c * r * r)
    want = np.asarray(jmdcl.subpixel_shuffle(jnp.asarray(x), r))
    got = tmdcl.subpixel_shuffle(tp.nchw(x), r)
    np.testing.assert_array_equal(tp.nhwc(got), want)
    t = tp.nchw(x)
    for h in range(2):
        for w_ in range(2):
            for dx in range(r):
                for dy in range(r):
                    for ch in range(c):
                        assert got[0, ch, h * r + dx, w_ * r + dy] == t[0, ch * r * r + r * dx + dy, h, w_]
