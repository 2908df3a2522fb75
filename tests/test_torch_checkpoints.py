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


# --- IANv1: MDCL names, the deconv rule, MADE masks ---------------------------


def test_unit_gain_rescales_mdcl_filters_and_spares_made():
    v = jax_config(tp.TINY_V1_JAX).init(jax.random.PRNGKey(0))
    out = tckpt.unit_gain(v, iaf_logsigma_gain=0.1)
    assert sorted(out) == sorted(v)
    for k, cin in {"RW": 8, "G_aW": 8, "G_bW": 2, "B_aW": 8, "B_bW": 4}.items():
        assert out[k].shape == (3, 3, cin, 2)
        np.testing.assert_allclose(out[k].std(), np.sqrt(2.0 / (3 * cin)), rtol=1e-5)
    np.testing.assert_allclose(out["dec_conv4.W"].std(), np.sqrt(2.0 / (25 * 16 / 4)), rtol=1e-5)
    for k in ("R_coeff_base", "G_b_coeff_3", "l_IAF_mu_input.weights_mask", "l_IAF_mu_input.W",
              "l_IAF_mu_output_D.W", "l_IAF_ls_input.W", "l_IAF_ls_output_D.b"):
        np.testing.assert_array_equal(out[k], np.asarray(v[k]))  # MADE stays as drawn
    for k in ("l_IAF_ls_output_W.W", "l_IAF_ls_output_D.W"):  # but for the damped log-sigma outputs
        np.testing.assert_allclose(out[k], 0.1 * np.asarray(v[k]), rtol=1e-6)
        np.testing.assert_array_equal(tckpt.unit_gain(v)[k], np.asarray(v[k]))  # only when asked
    np.testing.assert_allclose(tckpt.unit_gain(v, mdcl_taps=9.0)["RW"].std(), np.sqrt(2.0 / (9 * 8)), rtol=1e-5)


def test_mdcl_filters_named_dec_keep_conv_layout():
    """Full IAN's MDCL filters are `dec_conv2aW`, ...: conv kernels, though
    their names start like the deconvs'."""
    rng = np.random.RandomState(0)
    v = {"dec_conv2aW": rng.randn(3, 3, 4, 6).astype(np.float32),
         "dec_conv2.W": rng.randn(5, 5, 4, 6).astype(np.float32),
         "RW": rng.randn(3, 3, 4, 2).astype(np.float32)}
    port = tckpt.from_reference(v, "cpu")
    assert tuple(port["dec_conv2aW"].shape) == (6, 4, 3, 3)  # conv: (cout, cin, kh, kw)
    assert tuple(port["dec_conv2.W"].shape) == (4, 6, 5, 5)  # deconv: (cin, cout, kh, kw)
    assert tuple(port["RW"].shape) == (2, 4, 3, 3)
    np.testing.assert_array_equal(port["dec_conv2aW"][5, 3].numpy(), v["dec_conv2aW"][:, :, 3, 5])
    back = tckpt.to_reference(port)
    for k in v:
        np.testing.assert_array_equal(back[k], v[k])


def test_full_ianv1_layout_maps_are_exact_inverses():
    v = tp.jax_variables("IANv1")
    back = tckpt.to_reference(tckpt.from_reference(v, "cpu"))
    assert sorted(back) == sorted(v)
    for k in v:
        assert back[k].dtype == v[k].dtype and back[k].shape == v[k].shape, k
        np.testing.assert_array_equal(back[k], v[k])


def _with_ordering(jv, ordering):
    """npe_tpu variables whose MADE nets follow `ordering`, not seed 1234's."""
    from npe_tpu.ops.made import made_masks

    jv = dict(jv)
    for net in ("l_IAF_mu", "l_IAF_ls"):
        (m_in, m_out), direct = made_masks(len(ordering), [len(ordering)], ordering=ordering)
        jv[f"{net}_input.weights_mask"] = m_in
        jv[f"{net}_output_W.weights_mask"] = m_out
        jv[f"{net}_output_D.weights_mask"] = direct
    return jv


@pytest.mark.parametrize("own_ordering", [False, True])
def test_npe_tpu_ianv1_file_loads_with_masks_regenerated(tmp_path, caplog, own_ordering):
    jv = jax_config(tp.TINY_V1_JAX).init(jax.random.PRNGKey(0))
    if own_ordering:
        jv = _with_ordering(jv, np.random.RandomState(9).permutation(16))
    src, dst = tmp_path / "jax.npz", tmp_path / "port.npz"
    jckpt.save_weights(str(src), jv)
    with np.load(src) as f:
        assert not [k for k in f.files if k.endswith(".weights_mask")]
    port = torch_config(tp.TINY_V1_TORCH).init(torch.Generator().manual_seed(1), "cpu")
    with caplog.at_level(logging.WARNING):
        meta = tckpt.load_weights(str(src), port)
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    assert sorted(meta["made_orderings"]) == ["l_IAF_ls", "l_IAF_mu"]
    masks = [k for k in jv if k.endswith(".weights_mask")]
    assert len(masks) == 6
    for k in masks:  # regenerated from the file's orderings, not seed 1234's replay
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(jv[k]))
    assert tckpt.made_orderings_of(port) == jckpt.made_orderings_of(jv)
    # and back: the port's file equals npe_tpu's, array for array, and loads into npe_tpu
    tckpt.save_weights(str(dst), port)
    with np.load(src) as a, np.load(dst) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != tckpt.METADATA_KEY:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
        assert pickle.loads(b[tckpt.METADATA_KEY].tobytes()) == pickle.loads(a[tckpt.METADATA_KEY].tobytes())
    fresh = jax_config(tp.TINY_V1_JAX).init(jax.random.PRNGKey(5))
    with caplog.at_level(logging.WARNING):
        jckpt.load_weights(str(dst), fresh)
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    for k in jv:
        np.testing.assert_array_equal(np.asarray(fresh[k]), np.asarray(jv[k]))


def test_restore_made_masks_without_metadata_keeps_the_init_masks():
    port = torch_config(tp.TINY_V1_TORCH).init(torch.Generator().manual_seed(1), "cpu")
    before = {k: v.clone() for k, v in port.items() if k.endswith(".weights_mask")}
    tckpt.restore_made_masks(port, {})
    tckpt.restore_made_masks(port, {"made_orderings": {"some_other_net": [1, 0]}})
    for k, m in before.items():
        assert torch.equal(port[k], m)
