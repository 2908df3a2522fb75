"""npe_tpu_torch's copy of the Theano / Lasagne checkpoint converter against
npe_tpu's (`tests/test_convert.py`): the same layout changes, array for
array, and a Theano-layout file converted with the port's CLI loads into
the port."""

import pickle

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.utils import convert as jconvert
from npe_tpu_torch.models import get_config
from npe_tpu_torch.utils import checkpoints as tckpt
from npe_tpu_torch.utils import convert as tconvert

tp.torch_threads()


def _cases():
    rng = np.random.RandomState(4)
    return {
        "enc_conv2.W": rng.randn(256, 128, 5, 5).astype(np.float32),
        "dec_conv2.W": rng.randn(512, 256, 5, 5).astype(np.float32),
        "dec_conv2aW": rng.randn(64, 64, 3, 3).astype(np.float32),
        "enc_fc1.W": rng.randn(1024 * 16, 10).astype(np.float32),
        "mu_bnorm.gamma": rng.randn(100).astype(np.float32),
        "minibatch_discrim.theta": rng.randn(32, 8, 5).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_convert_param_both_ways_equals_npe_tpu(name):
    ref = _cases()[name]
    ours = tconvert.convert_param(name, ref)
    np.testing.assert_array_equal(ours, jconvert.convert_param(name, ref))
    back = tconvert.convert_param_to_theano(name, ours)
    np.testing.assert_array_equal(back, jconvert.convert_param_to_theano(name, ours))
    np.testing.assert_array_equal(back, ref)


@pytest.fixture
def tiny_fc1(monkeypatch):
    """Both converters' enc_fc1 geometry at the tiny profile's conv4 output
    (128, 4, 4), so that a whole tiny model goes through them."""
    for mod in (jconvert, tconvert):
        monkeypatch.setattr(mod, "FC1_SPATIAL", (128, 4, 4))


def test_cli_converts_a_theano_file_like_npe_tpu_and_the_port_loads_it(tmp_path, tiny_fc1, capsys):
    variables = tp.jax_variables(tp.TINY_JAX)  # npe_tpu's layouts
    theano = tmp_path / "theano.npz"
    jconvert.convert_to_theano_npz(variables, str(theano))
    # the reference stores its metadata pickled under 'metadata'
    with np.load(theano) as f:
        stored = {k: f[k] for k in f.files if k != tckpt.METADATA_KEY}
    np.savez(theano, metadata=np.asarray(pickle.dumps({"epoch": 3, "itr": 77})), **stored)

    ours, theirs = tmp_path / "port.npz", tmp_path / "npe_tpu.npz"
    tconvert.main([str(theano), str(ours)])
    assert f"wrote {ours}" in capsys.readouterr().out
    jconvert.convert_theano_npz(str(theano), str(theirs))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k != tckpt.METADATA_KEY:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    port = get_config(tp.TINY_TORCH).init(torch.Generator().manual_seed(1), "cpu")
    meta = tckpt.load_weights(str(ours), port)
    assert (meta["epoch"], meta["itr"]) == (3, 77)
    want = tp.port_variables(tp.TINY_JAX)
    assert sorted(port) == sorted(want)
    for k, t in want.items():
        assert torch.equal(port[k], t), k

    back = tmp_path / "back.npz"
    tconvert.main([str(ours), str(back), "--reverse"])
    with np.load(back) as f:
        for k, a in stored.items():
            np.testing.assert_array_equal(f[k], a, err_msg=k)


def test_convert_reads_python2_pickled_metadata(tmp_path):
    """The reference's metadata is a Python 2 cPickle (`train_IAN.py:571`);
    as npe_tpu's, the port's converter decodes it with latin1 instead of
    dropping it (the stream of tests/test_convert.py)."""
    raw = (
        b"\x80\x02}q\x00(X\x05\x00\x00\x00epochq\x01K\x05"
        b"X\x07\x00\x00\x00payloadq\x02U\x04ab\xb7cq\x03u."
    )
    src = tmp_path / "theano.npz"
    np.savez(src, metadata=np.asarray(raw), **{"bnorm2.beta": np.zeros(4, np.float32)})
    dst = tmp_path / "ours.npz"
    tconvert.convert_theano_npz(str(src), str(dst))
    meta = tckpt.load_weights(str(dst), {"bnorm2.beta": torch.ones(4)})
    assert meta["epoch"] == 5 and meta["payload"] == "ab\xb7c"


def test_convert_drops_metadata_that_is_no_dict(tmp_path, caplog):
    src = tmp_path / "theano.npz"
    np.savez(src, metadata=np.asarray(pickle.dumps([1, 2])), **{"enc_conv1.b": np.ones(3, np.float32)})
    dst = tmp_path / "ours.npz"
    out = tconvert.convert_theano_npz(str(src), str(dst))
    assert sorted(out) == ["enc_conv1.b"] and "not dict" in caplog.text
    assert tckpt.load_weights(str(dst), {"enc_conv1.b": torch.zeros(3)}) == {"format_version": 1}
