"""The port's import boundary and its checkpoint ABI: files written by
npe_tpu load into npe_tpu_torch, and files written by npe_tpu_torch load
into npe_tpu."""

import ast
import logging
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax

import torch_parity as tp
from npe_tpu.models import get_config as jax_config
from npe_tpu.utils import checkpoints as jckpt
from npe_tpu_torch.models import get_config as torch_config
from npe_tpu_torch.utils import checkpoints as tckpt

tp.torch_threads()

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "npe_tpu")


def _port_sources():
    return sorted((ROOT / "npe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_npe_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {mod}"


def test_layout_maps_are_exact_inverses():
    v = tp.jax_variables(tp.TINY_JAX)
    port = tckpt.from_reference(v, "cpu")
    assert tuple(port["enc_conv2.W"].shape) == (32, 16, 5, 5)  # (cout, cin, kh, kw)
    assert tuple(port["dec_conv1.W"].shape) == (128, 64, 5, 5)  # (cin, cout, kh, kw)
    assert tuple(port["enc_fc1.W"].shape) == v["enc_fc1.W"].shape  # rows unchanged
    back = tckpt.to_reference(port)
    assert sorted(back) == sorted(v)
    for k in v:
        np.testing.assert_array_equal(back[k], v[k])


def test_unit_gain_rescales_kernels_by_fan_in_only():
    v = jax_config(tp.TINY_JAX).init(jax.random.PRNGKey(0))
    out = tckpt.unit_gain(v)
    assert sorted(out) == sorted(v)
    fans = {"enc_conv2.W": 5 * 5 * 16, "dec_conv1.W": 5 * 5 * 128 / 4, "enc_fc1.W": v["enc_fc1.W"].shape[0]}
    for k, fan in fans.items():
        assert out[k].shape == v[k].shape and out[k].dtype == np.float32
        np.testing.assert_allclose(out[k].std(), np.sqrt(2.0 / fan), rtol=1e-5)
        np.testing.assert_allclose(out[k] / np.asarray(v[k]), out[k].flat[0] / np.asarray(v[k]).flat[0], rtol=1e-5)
    for k in ("bnorm2.beta", "bnorm2.inv_std", "enc_conv1.b", "minibatch_discrim.theta"):
        np.testing.assert_array_equal(out[k], np.asarray(v[k]))


def test_npe_tpu_file_round_trips_through_the_port(tmp_path, caplog):
    jv = jax_config(tp.TINY_JAX).init(jax.random.PRNGKey(0))
    src, dst = tmp_path / "jax.npz", tmp_path / "port.npz"
    jckpt.save_weights(str(src), jv, metadata={"epoch": 3})
    port = torch_config(tp.TINY_TORCH).init(torch.Generator().manual_seed(1), "cpu")
    with caplog.at_level(logging.WARNING):
        meta = tckpt.load_weights(str(src), port)
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    assert meta["epoch"] == 3 and meta["format_version"] == 1
    tckpt.save_weights(str(dst), port, metadata=meta)
    with np.load(src) as a, np.load(dst) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == tckpt.METADATA_KEY:
                continue
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        assert pickle.loads(b[tckpt.METADATA_KEY].tobytes()) == meta


def test_full_port_file_loads_into_npe_tpu(tmp_path, caplog):
    port = torch_config("IAN_simple").init(torch.Generator().manual_seed(0), "cpu")
    path = tmp_path / "IAN_simple.npz"
    tckpt.save_weights(str(path), port)
    jv = jax_config("IAN_simple").init(jax.random.PRNGKey(0))
    with caplog.at_level(logging.WARNING):
        jckpt.load_weights(str(path), jv)
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    ref = tckpt.to_reference(port)
    for k in ("enc_conv1.W", "dec_conv1.W", "enc_fc1.W", "minibatch_discrim.theta", "discrimi.W"):
        np.testing.assert_array_equal(np.asarray(jv[k]), ref[k])


def test_newer_format_version_is_refused(tmp_path):
    port = tp.port_variables(tp.TINY_JAX)
    path = tmp_path / "v2.npz"
    tckpt.save_weights(str(path), port, metadata={"format_version": 2})
    with pytest.raises(ValueError, match="format_version 2"):
        tckpt.load_weights(str(path), port)


def test_shape_mismatch_and_missing_names_warn_and_skip(tmp_path, caplog):
    port = tp.port_variables(tp.TINY_JAX)
    stored = tckpt.to_reference(port)
    stored["enc_conv1.W"] = np.zeros((3, 3, 3, 16), np.float32)  # wrong kernel size
    del stored["bnorm2.mean"]
    stored["extra.W"] = np.zeros(4, np.float32)
    path = tmp_path / "drift.npz"
    np.savez(path, **stored)
    before = port["enc_conv1.W"].clone()
    with caplog.at_level(logging.WARNING):
        tckpt.load_weights(str(path), port)
    text = caplog.text
    assert "shape mismatch for enc_conv1.W" in text
    assert "missing param bnorm2.mean" in text
    assert "unused param extra.W" in text
    assert torch.equal(port["enc_conv1.W"], before)  # skipped, not overwritten
