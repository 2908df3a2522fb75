"""npe_tpu_torch's IAN_simple, IANv1 and full IAN against npe_tpu's on the
same variables: every model function at the tiny widths of tests/tiny_ian.py,
tests/tiny_ianv1.py and tests/tiny_ian_full.py in both BN modes (full IAN in
both MDBLOCK forms), and one full-width encode + decode each."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.models import get_config as jax_config
from npe_tpu_torch.models import common
from npe_tpu_torch.models import get_config as torch_config
from npe_tpu_torch.utils import checkpoints as tckpt

tp.torch_threads()


def _images(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_tiny_encode_stats_matches_jax(train):
    jm, tm = jax_config(tp.TINY_JAX), torch_config(tp.TINY_TORCH)
    x = _images(4)
    jupd, tupd = {}, {}
    jmu, jls, jfeats = jm.encode_stats(tp.jax_variables(tp.TINY_JAX), x.transpose(0, 2, 3, 1), train, jupd)
    tmu, tls, tfeats = tm.encode_stats(tp.port_variables(tp.TINY_JAX), torch.from_numpy(x), train, tupd)
    tp.assert_close(tmu.numpy(), jmu)
    tp.assert_close(tls.numpy(), jls)
    assert len(tfeats) == 4
    for a, b in zip(tfeats, jfeats):
        tp.assert_close(tp.nhwc(a), b)
    assert sorted(tupd) == sorted(jupd) and (len(jupd) > 0) == train
    for k in jupd:
        tp.assert_close(tupd[k].numpy(), jupd[k])


@pytest.mark.parametrize("train", [False, True])
def test_tiny_decode_matches_jax(train):
    jm, tm = jax_config(tp.TINY_JAX), torch_config(tp.TINY_TORCH)
    z = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    jupd, tupd = {}, {}
    want = np.asarray(jm.decode(tp.jax_variables(tp.TINY_JAX), z, train, jupd))
    got = tm.decode(tp.port_variables(tp.TINY_JAX), torch.from_numpy(z), train, tupd)
    assert got.shape == (4, 3, 64, 64)
    assert np.abs(want).max() > 0.1  # unit-gain weights: not a vacuous match
    tp.assert_close(tp.nhwc(got), want)
    assert sorted(tupd) == sorted(jupd)
    for k in jupd:
        tp.assert_close(tupd[k].numpy(), jupd[k])


def test_full_width_ian_simple_encode_decode():
    jm, tm = jax_config("IAN_simple"), torch_config("IAN_simple")
    jv = tp.jax_variables("IAN_simple")
    x = _images(2, seed=2)
    jz = np.asarray(jm.encode(jv, x.transpose(0, 2, 3, 1)))
    jx = np.asarray(jm.decode(jv, jz))
    tv = tp.port_variables("IAN_simple")
    with torch.no_grad():
        tz = tm.encode(tv, torch.from_numpy(x))
        tx = tm.decode(tv, tz)
    assert tz.shape == (2, 100) and tx.shape == (2, 3, 64, 64)
    tp.assert_close(tz.numpy(), jz)
    tp.assert_close(tp.nhwc(tx), jx)


def test_get_config():
    from npe_tpu_torch.models import REGISTRY, ian, ian_simple, ian_v1

    assert torch_config("IAN_simple") is ian_simple
    assert torch_config("some/dir/IAN_simple.py") is ian_simple
    assert torch_config("IANv1") is ian_v1
    assert torch_config("some/dir/IANv1.py") is ian_v1
    assert torch_config("IAN") is ian
    assert torch_config("some/dir/IAN.py") is ian
    from npe_tpu.models import REGISTRY as JAX_REGISTRY

    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)  # every model config of npe_tpu
    with pytest.raises(KeyError):
        torch_config("no_such_model")
    tiny = torch_config(tp.TINY_TORCH)
    assert tiny.cfg["num_latents"] == 16
    z, mu, ls = tiny.iaf(None, torch.ones(2, 16))
    assert torch.equal(z, torch.ones(2, 16)) and not mu.any() and not ls.any()


# --- IANv1 -------------------------------------------------------------------


def _v1():
    return (jax_config(tp.TINY_V1_JAX), torch_config(tp.TINY_V1_TORCH),
            tp.jax_variables(tp.TINY_V1_JAX), tp.port_variables(tp.TINY_V1_JAX))


def test_ianv1_cfg_and_init_mirror_npe_tpu():
    import jax

    from npe_tpu_torch.models import ian_v1

    jm = jax_config("IANv1")
    assert ian_v1.cfg == jm.cfg and ian_v1.lr_schedule == {0: 0.0002, 25: 0.0001, 50: 0.00005, 75: 0.00001}
    assert ian_v1.HAS_IAF and ian_v1.MADE_HIDDEN == jm.MADE_HIDDEN
    jm, tm, _, _ = _v1()
    jv = jm.init(jax.random.PRNGKey(0))
    tv = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert sorted(tv) == sorted(jv)
    ported = tp.port_variables(tp.TINY_V1_JAX)
    for k in tv:
        assert tv[k].shape == ported[k].shape and tv[k].dtype == torch.float32, k
        if k.endswith(".weights_mask") or "_coeff_" in k:
            np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
    assert abs(float(tv["RW"].std()) - 0.02) < 5e-3  # Lasagne Normal(0.02)


@pytest.mark.parametrize("train", [False, True])
def test_tiny_ianv1_encode_stats_matches_jax(train):
    jm, tm, jv, tv = _v1()
    x = _images(4, seed=3)
    jupd, tupd = {}, {}
    jmu, jls, jfeats = jm.encode_stats(jv, x.transpose(0, 2, 3, 1), train, jupd)
    tmu, tls, tfeats = tm.encode_stats(tv, torch.from_numpy(x), train, tupd)
    tp.assert_close(tmu.numpy(), jmu)
    tp.assert_close(tls.numpy(), jls)
    for a, b in zip(tfeats, jfeats):
        tp.assert_close(tp.nhwc(a), b)
    assert sorted(tupd) == sorted(jupd) and (len(jupd) > 0) == train
    for k in jupd:
        tp.assert_close(tupd[k].numpy(), jupd[k])


def test_tiny_ianv1_latent_path_matches_jax():
    """encode_pre_iaf, iaf and encode, each against npe_tpu's."""
    jm, tm, jv, tv = _v1()
    x = _images(4, seed=4)
    jmu = np.array(jm.encode_pre_iaf(jv, x.transpose(0, 2, 3, 1)))
    tp.assert_close(tm.encode_pre_iaf(tv, torch.from_numpy(x)).numpy(), jmu)
    jz, jm_, jl = (np.asarray(a) for a in jm.iaf(jv, jmu))
    tz, tm_, tl = (a.numpy() for a in tm.iaf(tv, torch.from_numpy(jmu)))
    assert np.abs(jm_).max() > 0.1 and np.abs(jl).max() > 0.01  # the flow does something
    assert np.abs(jz).max() < 20  # ... and does not blow the latents up
    tp.assert_close(tz, jz)
    tp.assert_close(tm_, jm_)
    tp.assert_close(tl, jl)
    tp.assert_close(tm.encode(tv, torch.from_numpy(x)).numpy(), np.asarray(jm.encode(jv, x.transpose(0, 2, 3, 1))))


@pytest.mark.parametrize("train", [False, True])
def test_tiny_ianv1_decode_matches_jax(train):
    jm, tm, jv, tv = _v1()
    z = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    jupd, tupd = {}, {}
    want = np.asarray(jm.decode(jv, z, train, jupd))
    got = tm.decode(tv, torch.from_numpy(z), train, tupd)
    assert got.shape == (4, 3, 64, 64)
    assert want.std() > 0.1  # unit-gain weights: Beta means that vary, not zeros
    tp.assert_close(tp.nhwc(got), want)
    assert sorted(tupd) == sorted(jupd) and (len(jupd) > 0) == train
    for k in jupd:
        tp.assert_close(tupd[k].numpy(), jupd[k])
    jupd, tupd = {}, {}
    want = np.asarray(jm.decode_pre_iaf(jv, z, train, jupd))
    tp.assert_close(tp.nhwc(tm.decode_pre_iaf(tv, torch.from_numpy(z), train, tupd)), want)
    assert sorted(tupd) == sorted(jupd)


def test_full_width_ianv1_encode_decode():
    jm, tm = jax_config("IANv1"), torch_config("IANv1")
    jv = tp.jax_variables("IANv1")
    x = _images(2, seed=6)
    jz = np.asarray(jm.encode(jv, x.transpose(0, 2, 3, 1)))
    jx = np.asarray(jm.decode(jv, jz))
    tv = tp.port_variables("IANv1")
    assert tv["dec_conv4.W"].shape == (128, 64, 5, 5) and tv["RW"].shape == (2, 64, 3, 3)
    with torch.no_grad():
        tz = tm.encode(tv, torch.from_numpy(x))
        tx = tm.decode(tv, tz)
    assert tz.shape == (2, 100) and tx.shape == (2, 3, 64, 64)
    assert jx.std() > 0.1
    tp.assert_close(tz.numpy(), jz)
    tp.assert_close(tp.nhwc(tx), jx)


# --- full IAN ----------------------------------------------------------------


def _full(bn_state=False):
    jv = tp.jax_variables(tp.TINY_FULL_JAX)
    if bn_state:
        jv = tp.with_bn_state(jv, seed=11)
    # as jax arrays: npe_tpu's branch-per-scale MDCL updates a filter with `.at`
    return (jax_config(tp.TINY_FULL_JAX), torch_config(tp.TINY_FULL_TORCH), tp.as_jax(jv),
            tckpt.from_reference(jv, "cpu"))


def test_ian_cfg_and_init_mirror_npe_tpu():
    import jax

    from npe_tpu_torch.models import ian

    jm = jax_config("IAN")
    assert ian.cfg == jm.cfg and ian.lr_schedule == jm.lr_schedule
    assert (ian.NUM_LATENTS, ian.N_DISCRIM_CLASSES, ian.HAS_IAF) == (100, 3, True)
    assert ian.MADE_HIDDEN == jm.MADE_HIDDEN
    jm, tm, _, _ = _full()
    assert tm.cfg == jm.cfg
    jv = jm.init(jax.random.PRNGKey(0))
    tv = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert list(tv) == list(jv)  # every name, in npe_tpu's draw order
    ported = tp.port_variables(tp.TINY_FULL_JAX)
    for k in tv:
        assert tv[k].shape == ported[k].shape and tv[k].dtype == torch.float32, k
        if k.endswith(".weights_mask") or "_coeff_" in k:
            np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
    assert tv["dec_conv2aW"].shape == (64, 64, 3, 3) and tv["dec_conv1.W"].shape == (64, 64, 5, 5)
    assert float(tv["dec_conv2a_coeff_1x1"][0]) == pytest.approx(1 / 3)
    assert float(tv["dec_conv3a2_coeff_3"][0]) == pytest.approx(1 / 4)


def test_full_width_ian_init_has_every_name_and_shape_of_npe_tpu():
    import jax

    jshapes = jax.eval_shape(jax_config("IAN").init, jax.random.PRNGKey(0))
    tv = torch_config("IAN").init(torch.Generator().manual_seed(0), "cpu")
    assert sorted(tv) == sorted(jshapes)  # eval_shape returns the dict sorted
    for k, t in tv.items():
        want = tckpt._to_port_layout(k, np.empty(jshapes[k].shape, np.bool_)).shape
        assert tuple(t.shape) == tuple(want), k


@pytest.mark.parametrize("train", [False, True])
def test_tiny_ian_encode_stats_and_latent_path_match_jax(train):
    jm, tm, jv, tv = _full(bn_state=True)
    x = _images(4, seed=7)
    jupd, tupd = {}, {}
    jmu, jls, jfeats = jm.encode_stats(jv, x.transpose(0, 2, 3, 1), train, jupd)
    tmu, tls, tfeats = tm.encode_stats(tv, torch.from_numpy(x), train, tupd)
    tp.assert_close(tmu.numpy(), jmu)
    tp.assert_close(tls.numpy(), jls)
    for a, b in zip(tfeats, jfeats):
        tp.assert_close(tp.nhwc(a), b)
    assert sorted(tupd) == sorted(jupd) and (len(jupd) > 0) == train
    for k in jupd:
        tp.assert_close(tupd[k].numpy(), jupd[k])
    if not train:
        jmu = np.array(jm.encode_pre_iaf(jv, x.transpose(0, 2, 3, 1)))
        tp.assert_close(tm.encode_pre_iaf(tv, torch.from_numpy(x)).numpy(), jmu)
        for a, b in zip(tm.iaf(tv, torch.from_numpy(jmu)), jm.iaf(jv, jmu)):
            tp.assert_close(a.numpy(), np.asarray(b))
        tp.assert_close(tm.encode(tv, torch.from_numpy(x)).numpy(),
                        np.asarray(jm.encode(jv, x.transpose(0, 2, 3, 1))))


@pytest.mark.parametrize("mdblock_mode", [None, "plain", "fused"])
@pytest.mark.parametrize("train", [False, True])
def test_tiny_ian_decode_matches_jax(train, mdblock_mode):
    """Both MDBLOCK forms in both BN modes, with every norm's state off the
    identity; with train=True the fused mode runs the per-op form too."""
    from npe_tpu_torch.ops.kernels.mdblock import mdblock_fused

    jm, tm, jv, tv = _full(bn_state=True)
    z = np.random.RandomState(8).randn(4, 16).astype(np.float32)
    jupd, tupd = {}, {}
    want = np.asarray(jm.decode(jv, z, train, jupd))
    launches = mdblock_fused.launches
    got = tm.decode(tv, torch.from_numpy(z), train, tupd, mdblock_mode=mdblock_mode)
    assert got.shape == (4, 3, 64, 64) and mdblock_fused.launches == launches
    assert want.std() > 0.1
    tp.assert_close(tp.nhwc(got), want)
    assert sorted(tupd) == sorted(jupd) and (len(jupd) == 20) == train  # 9 MDBLOCK norms and bnorm_dc4
    for k in jupd:
        tp.assert_close(tupd[k].numpy(), jupd[k])
    jupd, tupd = {}, {}
    want = np.asarray(jm.decode_pre_iaf(jv, z, train, jupd))
    got = tm.decode_pre_iaf(tv, torch.from_numpy(z), train, tupd, mdblock_mode=mdblock_mode)
    tp.assert_close(tp.nhwc(got), want)
    assert sorted(tupd) == sorted(jupd)


def test_tiny_ian_decode_takes_head_and_mdblock_modes_together():
    _, tm, _, tv = _full(bn_state=True)
    z = torch.from_numpy(np.random.RandomState(9).randn(2, 16).astype(np.float32))
    want = tm.decode(tv, z)
    for head_mode in ("plain", "fused"):
        tp.assert_close(tm.decode(tv, z, head_mode=head_mode, mdblock_mode="fused").numpy(), want.numpy())
    with pytest.raises(ValueError, match="unknown MDBLOCK mode"):
        tm.decode(tv, z, mdblock_mode="pallas")


def test_unit_gain_keeps_the_full_ian_decoder_of_order_one():
    """The MDBLOCK filters' fan (their own scale sets and coefficients, at
    gain 1 on the residual branch) keeps three blocks in a row O(1): every
    block's input and output, tiny and at full width."""
    from npe_tpu_torch.models import common, ian

    for config, zdim in ((tp.TINY_FULL_JAX, 16), ("IAN", 100)):
        tv = tp.port_variables(config)
        stds = []
        real = common.mdblock

        def spy(v, upd, name, x, *args, **kwargs):
            y = real(v, upd, name, x, *args, **kwargs)
            stds.extend([float(x.std()), float(y.std())])
            return y

        ian.mdblock = spy
        try:
            with torch.no_grad():
                out = ian.decode(tv, torch.from_numpy(np.random.RandomState(10).randn(2, zdim).astype(np.float32)))
        finally:
            ian.mdblock = real
        assert len(stds) == 6 and all(0.5 < s < 3.0 for s in stds), stds
        assert out.std() > 0.3


def test_full_width_ian_encode_decode():
    """Full IAN at full width, once, at batch 1: encode, then decode in both
    MDBLOCK forms (the fused form at 512, 256 and 128 channels)."""
    jm, tm = jax_config("IAN"), torch_config("IAN")
    jv = tp.as_jax(tp.jax_variables("IAN"))
    x = _images(1, seed=12)
    jz = np.asarray(jm.encode(jv, x.transpose(0, 2, 3, 1)))
    jx = np.asarray(jm.decode(jv, jz))
    tv = tp.port_variables("IAN")
    assert tv["dec_conv2aW"].shape == (512, 512, 3, 3) and tv["dec_conv4.W"].shape == (128, 128, 5, 5)
    with torch.no_grad():
        tz = tm.encode(tv, torch.from_numpy(x))
        tx = tm.decode(tv, tz)
        tx_fused = tm.decode(tv, tz, mdblock_mode="fused")
    assert tz.shape == (1, 100) and tx.shape == (1, 3, 64, 64)
    assert jx.std() > 0.1
    tp.assert_close(tz.numpy(), jz)
    tp.assert_close(tp.nhwc(tx), jx)
    tp.assert_close(tp.nhwc(tx_fused), jx)


# --- what the training and evaluation code reads from a model module ------------

TRAINING_NAMES = ("cfg", "NUM_LATENTS", "N_DISCRIM_CLASSES", "HAS_IAF", "init", "backbone", "discrim_logits",
                  "encode_stats", "encode", "encode_pre_iaf", "iaf", "decode", "decode_pre_iaf", "sample_latent")


@pytest.mark.parametrize("name", ["IAN_simple", "IANv1", "IAN"])
def test_every_name_the_training_code_reads_exists_in_the_port(name):
    from npe_tpu.models import REGISTRY as JAX_REGISTRY
    from npe_tpu_torch.models import REGISTRY

    jm, tm = JAX_REGISTRY[name], REGISTRY[name]
    for attr in TRAINING_NAMES:
        assert hasattr(jm, attr), attr  # the list is npe_tpu's
        assert hasattr(tm, attr), f"npe_tpu_torch.models.{name} lacks {attr}"
    assert tm.HAS_IAF == jm.HAS_IAF and tm.N_DISCRIM_CLASSES == jm.N_DISCRIM_CLASSES
    assert tm.backbone is common.apply_backbone and tm.discrim_logits is common.apply_discrim_head
    if not tm.HAS_IAF:  # the pre-IAF and decoder-input latents coincide
        assert tm.encode_pre_iaf is tm.encode and tm.decode_pre_iaf is tm.decode
    # every public function npe_tpu's module defines has a counterpart of the same name
    public = [k for k, v in vars(jm).items() if callable(v) and not k.startswith("_")
              and getattr(v, "__module__", "") == jm.__name__]
    assert "decode" in public
    assert not [k for k in public if not hasattr(tm, k)]


@pytest.mark.parametrize("config", [(tp.TINY_JAX, tp.TINY_TORCH), (tp.TINY_V1_JAX, tp.TINY_V1_TORCH),
                                    (tp.TINY_FULL_JAX, tp.TINY_FULL_TORCH)], ids=["IAN_simple", "IANv1", "IAN"])
def test_tiny_discrim_head_matches_jax(config):
    jm, tm = jax_config(config[0]), torch_config(config[1])
    for attr in TRAINING_NAMES:
        assert hasattr(jm, attr) and hasattr(tm, attr), attr
    jv = tp.jax_variables(config[0])
    tv = tp.port_variables(config[0])
    x = np.random.RandomState(4).uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.discrim_logits(jv, jm.backbone(jv, x, True, None)[-1]))
    got = tm.discrim_logits(tv, tm.backbone(tv, tp.nchw(x), True, None)[-1])
    assert tuple(got.shape) == want.shape == (4, tm.N_DISCRIM_CLASSES)
    tp.assert_close(got.numpy(), want)
    assert common.is_trainable("enc_conv1.W") and not common.is_trainable("bnorm2.inv_std")
    params, state = common.split_trainable(tv)
    assert sorted(list(params) + list(state)) == sorted(tv) and not set(params) & set(state)
    assert state and all(k.endswith(common.NON_TRAINABLE_SUFFIXES) for k in state)
