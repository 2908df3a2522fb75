"""npe_tpu_torch's IAN_simple and IANv1 against npe_tpu's on the same
variables: every model function at the tiny widths of tests/tiny_ian.py and
tests/tiny_ianv1.py in both BN modes, and one full-width encode + decode
each."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.models import get_config as jax_config
from npe_tpu_torch.models import get_config as torch_config

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
    from npe_tpu_torch.models import ian_simple, ian_v1

    assert torch_config("IAN_simple") is ian_simple
    assert torch_config("some/dir/IAN_simple.py") is ian_simple
    assert torch_config("IANv1") is ian_v1
    assert torch_config("some/dir/IANv1.py") is ian_v1
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_config("IAN")
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
