"""npe_tpu_torch's IAN_simple against npe_tpu's on the same variables:
encode_stats and decode at the tiny widths of tests/tiny_ian.py in both BN
modes, and one full-width encode + decode."""

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
    from npe_tpu_torch.models import ian_simple

    assert torch_config("IAN_simple") is ian_simple
    assert torch_config("some/dir/IAN_simple.py") is ian_simple
    for name in ("IAN", "IANv1"):
        with pytest.raises(NotImplementedError, match="not ported"):
            torch_config(name)
    with pytest.raises(KeyError):
        torch_config("no_such_model")
    tiny = torch_config(tp.TINY_TORCH)
    assert tiny.cfg["num_latents"] == 16
    z, mu, ls = tiny.iaf(None, torch.ones(2, 16))
    assert torch.equal(z, torch.ones(2, 16)) and not mu.any() and not ls.any()
