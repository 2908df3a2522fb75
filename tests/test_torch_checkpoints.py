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
# JAX, the JAX package, and the JAX package's root scripts (they import JAX)
FORBIDDEN = ("jax", "jaxlib", "optax", "npe_tpu", "bench", "bench_train", "bench_stages", "bench_edit",
             "bench_serving", "bench_deconv_ab", "bench_head_ab", "bench_mdblock_ab", "NPE", "__graft_entry__")


def _port_sources():
    return sorted((ROOT / "npe_tpu_torch").rglob("*.py")) + [
        ROOT / f"{name}.py" for name in ("chip_smoke", "bench_torch", "bench_torch_edit", "bench_torch_serving",
                                          "bench_torch_stages", "bench_torch_train")] + [
        ROOT / "scripts" / f"{name}.py" for name in ("kernel_ab", "kernel_sweep", "launch_floor")]


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


def test_float64_file_decodes_in_float32_as_in_npe_tpu(tmp_path, caplog):
    """A weight file of float64 arrays (a numpy writer's, or a converted
    float64 source): npe_tpu computes it in float32 (x64 off), and so must
    the port; it used to keep float64 and every decode raised."""
    jv = tp.jax_variables(tp.TINY_JAX)
    path = tmp_path / "f64.npz"
    jckpt.save_weights(str(path), {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in jv.items()})
    with np.load(path) as f:
        assert f["dec_conv1.W"].dtype == np.float64
    jm, tm = jax_config(tp.TINY_JAX), torch_config(tp.TINY_TORCH)
    jfresh = jax_config(tp.TINY_JAX).init(jax.random.PRNGKey(4))
    port = tm.init(torch.Generator().manual_seed(4), "cpu")
    with caplog.at_level(logging.WARNING):
        jckpt.load_weights(str(path), jfresh)
        tckpt.load_weights(str(path), port)
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    assert all(t.dtype == torch.float32 for t in port.values() if t.is_floating_point())
    z = np.random.RandomState(2).randn(2, 16).astype(np.float32)
    want = np.asarray(jm.decode(jfresh, z))
    got = tm.decode(port, torch.from_numpy(z))
    assert want.dtype == np.float32 and got.dtype == torch.float32 and np.abs(want).max() > 0.1
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("include_masks", [False, True])
def test_port_files_of_every_kind_load_into_both_packages(tmp_path, caplog, include_masks, compress):
    """save_weights takes npe_tpu's include_masks and compress keywords; the
    four kinds of file it writes load into npe_tpu and into the port, masks
    included, in npe_tpu's layout."""
    import zipfile

    jv = jax_config(tp.TINY_V1_JAX).init(jax.random.PRNGKey(0))
    jv = _with_ordering(jv, np.random.RandomState(3).permutation(16))
    port = tckpt.from_reference(jv, "cpu")
    path = tmp_path / "port.npz"
    tckpt.save_weights(str(path), port, metadata={"epoch": 1}, include_masks=include_masks, compress=compress)
    with zipfile.ZipFile(path) as z:
        kinds = {i.compress_type for i in z.infolist()}
    assert kinds == {zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED}
    masks = [k for k in jv if k.endswith(".weights_mask")]
    with np.load(path) as f:
        assert sorted(k for k in f.files if k.endswith(".weights_mask")) == (sorted(masks) if include_masks else [])
        for k in masks if include_masks else ():
            np.testing.assert_array_equal(f[k], np.asarray(jv[k]))
    jfresh = jax_config(tp.TINY_V1_JAX).init(jax.random.PRNGKey(5))
    tfresh = torch_config(tp.TINY_V1_TORCH).init(torch.Generator().manual_seed(5), "cpu")
    with caplog.at_level(logging.WARNING):
        assert jckpt.load_weights(str(path), jfresh)["epoch"] == 1
        assert tckpt.load_weights(str(path), tfresh)["epoch"] == 1
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    back = tckpt.to_reference(tfresh)
    for k in jv:
        np.testing.assert_array_equal(np.asarray(jfresh[k]), np.asarray(jv[k]), err_msg=k)
        np.testing.assert_array_equal(back[k], np.asarray(jv[k]), err_msg=k)


def test_restore_made_masks_without_metadata_keeps_the_init_masks():
    port = torch_config(tp.TINY_V1_TORCH).init(torch.Generator().manual_seed(1), "cpu")
    before = {k: v.clone() for k, v in port.items() if k.endswith(".weights_mask")}
    tckpt.restore_made_masks(port, {})
    tckpt.restore_made_masks(port, {"made_orderings": {"some_other_net": [1, 0]}})
    for k, m in before.items():
        assert torch.equal(port[k], m)


# --- full IAN: MDBLOCK filters, their fan, an npe_tpu file ---------------------


def test_unit_gain_gives_mdblock_filters_their_own_fan():
    """The fan of an MDCL filter follows its scale set and coefficients; an
    MDBLOCK's two filters, on a residual branch, take gain 1 instead of 2."""
    v = jax_config(tp.TINY_FULL_JAX).init(jax.random.PRNGKey(0))
    out = tckpt.unit_gain(v, iaf_logsigma_gain=0.1)
    assert sorted(out) == sorted(v)
    assert tckpt.mdcl_fan_taps(v, "R") == pytest.approx(3.0)  # scales [2, 3, 4] at 1/4: the head's, as before
    taps_02, taps_023 = tckpt.mdcl_fan_taps(v, "dec_conv2a"), tckpt.mdcl_fan_taps(v, "dec_conv3a2")
    assert taps_02 == pytest.approx((19 / 27) ** 2 + 8 / 27**2 + 16 / 9)  # scales [0, 2] at 1/3
    assert taps_023 == pytest.approx((28 / 36) ** 2 + 8 / 36**2 + 24 / 16)  # scales [0, 2, 3] at 1/4
    for k, cin, taps in (("dec_conv2aW", 64, taps_02), ("dec_conv2a2W", 64, taps_02),
                         ("dec_conv3aW", 32, taps_023), ("dec_conv4a2W", 16, taps_023)):
        assert out[k].shape == (3, 3, cin, cin)
        np.testing.assert_allclose(out[k].std(), np.sqrt(1.0 / (taps * cin)), rtol=1e-5)
    np.testing.assert_allclose(out["RW"].std(), np.sqrt(2.0 / (3 * 16)), rtol=1e-5)
    np.testing.assert_allclose(out["dec_conv2.W"].std(), np.sqrt(2.0 / (25 * 64 / 4)), rtol=1e-5)
    for k in ("dec_conv2a_coeff_1x1", "dec_conv3abnorm1.gamma", "dec_conv1.b", "l_IAF_mu_input.W"):
        np.testing.assert_array_equal(out[k], np.asarray(v[k]))


def test_npe_tpu_full_ian_file_loads_with_masks_regenerated(tmp_path, caplog):
    """An npe_tpu full-IAN file into the port: no warning, MADE masks from
    the file's orderings, `dec_conv*aW` as conv kernels (not transposed as
    the deconvs `dec_conv*.W` are), and the port's file equals npe_tpu's."""
    jv = _with_ordering(jax_config(tp.TINY_FULL_JAX).init(jax.random.PRNGKey(0)),
                        np.random.RandomState(4).permutation(16))
    jv["dec_conv3aW"] = np.random.RandomState(5).randn(3, 3, 32, 32).astype(np.float32)
    src, dst = tmp_path / "jax.npz", tmp_path / "port.npz"
    jckpt.save_weights(str(src), jv)
    port = torch_config(tp.TINY_FULL_TORCH).init(torch.Generator().manual_seed(1), "cpu")
    with caplog.at_level(logging.WARNING):
        tckpt.load_weights(str(src), port)
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    for k in (k for k in jv if k.endswith(".weights_mask")):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(jv[k]))
    w = np.asarray(jv["dec_conv3aW"])
    assert tuple(port["dec_conv3aW"].shape) == (32, 32, 3, 3)
    np.testing.assert_array_equal(port["dec_conv3aW"][5, 3].numpy(), w[:, :, 3, 5])  # (cout, cin) <- (.., cin, cout)
    d = np.asarray(jv["dec_conv3.W"])
    np.testing.assert_array_equal(port["dec_conv3.W"][5, 3].numpy(), d[:, :, 5, 3])  # deconv: (cin, cout)
    tckpt.save_weights(str(dst), port)
    with np.load(src) as a, np.load(dst) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != tckpt.METADATA_KEY:
                np.testing.assert_array_equal(a[k], b[k])


# --- train state ----------------------------------------------------------------


def _jax_train_state(moments_dtype=None, steps=1):
    """An npe_tpu train state of the tiny full IAN after `steps` G + D pairs,
    as a nested tree of numpy arrays."""
    import jax.numpy as jnp

    from npe_tpu.training import train_step as JTS

    jm = jax_config(tp.TINY_FULL_JAX)
    cfg = dict(jm.cfg, **({"moments_dtype": moments_dtype} if moments_dtype else {}))
    state = JTS.init_train_state(jm, tp.as_jax(tp.jax_variables(tp.TINY_FULL_JAX)), cfg)
    x, z, key, _ = tp.training_batch(cfg)
    gen_step, discrim_step = JTS.make_train_steps(jm, cfg, donate=False)
    for _ in range(steps):
        state, _ = gen_step(state, jnp.asarray(x), jnp.asarray(z), key, 2e-4)
        state, _ = discrim_step(state, jnp.asarray(x), jnp.asarray(z), key, 2e-4)
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["float32-moments", "bfloat16-moments"])
def jax_train_state(request):
    return request.param, _jax_train_state(request.param)


def test_train_state_crosses_to_the_port_and_back(jax_train_state):
    moments_dtype, state_np = jax_train_state
    port = tckpt.train_state_from_reference(state_np, "cpu")
    assert sorted(port) == ["opt", "parts", "step"] and int(port["step"]) == 2
    assert int(port["opt"]["latent"]["count"]) == 2 and int(port["opt"]["gen"]["count"]) == 1
    want_dtype = torch.bfloat16 if moments_dtype else torch.float32
    # kernels and their moments in the port's layouts
    for tree in (port["parts"]["gen"], port["opt"]["gen"]["mu"], port["opt"]["gen"]["nu"]):
        assert tuple(tree["dec_conv1.W"].shape) == (64, 64, 5, 5)  # deconv (cin, cout, kh, kw)
        assert tuple(tree["dec_conv2aW"].shape) == (64, 64, 3, 3)  # MDCL filter, conv layout
    assert tuple(port["opt"]["discrim"]["nu"]["enc_conv2.W"].shape) == (32, 16, 5, 5)
    assert all(t.dtype == want_dtype for o in port["opt"].values() for m in ("mu", "nu") for t in o[m].values())
    assert port["parts"]["gen"]["dec_conv1.W"].dtype == torch.float32
    assert any(k.endswith(".weights_mask") for k in port["parts"]["state"]) and port["parts"]["frozen"]
    back = tckpt.train_state_to_reference(port)
    for part, variables in state_np["parts"].items():
        assert sorted(back["parts"][part]) == sorted(variables)
        for k, v in variables.items():
            np.testing.assert_array_equal(back["parts"][part][k], v, err_msg=k)
    for part, opt in state_np["opt"].items():
        assert int(back["opt"][part]["count"]) == int(opt.count)
        for moment, tree in (("mu", opt.mu), ("nu", opt.nu)):
            for k, v in tree.items():
                assert back["opt"][part][moment][k].dtype == v.dtype, k
                np.testing.assert_array_equal(back["opt"][part][moment][k].astype(np.float32),
                                              v.astype(np.float32), err_msg=k)


def test_train_state_file_round_trip(jax_train_state, tmp_path):
    moments_dtype, state_np = jax_train_state
    state = tckpt.train_state_from_reference(state_np, "cpu")
    fname = str(tmp_path / "state.npz")
    meta = {"epoch": 3, "itr": 12, "ts": 1.5, "learning_rate": 1e-4}
    tckpt.save_train_state(fname, state, metadata=meta)
    assert not [p for p in tmp_path.iterdir() if ".tmp-" in p.name]  # the temp file was renamed away
    assert tckpt.train_state_metadata(fname) == {**meta, "format_version": 1}
    with np.load(fname, allow_pickle=False) as f:
        stored = set(f.files)
        raw = pickle.loads(f["__metadata__"].tobytes())
        # named leaves in npe_tpu's layouts; bfloat16 as raw 16-bit words with the dtype recorded
        assert {"parts/gen/dec_conv1.W", "opt/gen/mu/dec_conv1.W", "opt/gen/count", "step"} <= stored
        assert f["parts/gen/dec_conv1.W"].shape == (5, 5, 64, 64) and f["opt/gen/nu/dec_conv1.W"].shape == (5, 5, 64, 64)
        assert f["opt/gen/mu/dec_conv1.W"].dtype == (np.uint16 if moments_dtype else np.float32)
    assert raw["leaf_dtypes"]["opt/gen/mu/dec_conv1.W"] == (moments_dtype or "float32")
    assert raw["leaf_dtypes"]["opt/gen/count"] == "int32"
    loaded = tckpt.load_train_state(fname, "cpu")
    flat, want = tckpt._flat_train_state(loaded), tckpt._flat_train_state(state)
    assert list(flat) == list(want)
    for path in want:
        assert flat[path][1].dtype == want[path][1].dtype and torch.equal(flat[path][1], want[path][1]), path
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):  # the card is the default
            tckpt.load_train_state(fname)


def test_train_state_file_of_a_newer_format_is_refused(tmp_path):
    state = {"parts": {"gen": {"a.W": torch.ones(2, 2)}}, "opt": {"gen": {"count": torch.zeros((), dtype=torch.int32),
             "mu": {"a.W": torch.zeros(2, 2)}, "nu": {"a.W": torch.zeros(2, 2)}}}, "step": torch.zeros((), dtype=torch.int32)}
    fname = str(tmp_path / "future.npz")
    tckpt.save_train_state(fname, state, metadata={"format_version": 2})
    with pytest.raises(ValueError, match="format_version 2"):
        tckpt.load_train_state(fname, "cpu")
    tckpt.save_train_state(fname, state)
    assert tckpt.train_state_metadata(fname) == {"format_version": 1}
    loaded = tckpt.load_train_state(fname, "cpu")
    assert torch.equal(loaded["parts"]["gen"]["a.W"], torch.ones(2, 2)) and loaded["step"].ndim == 0
