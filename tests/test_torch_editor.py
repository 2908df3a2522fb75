"""npe_tpu_torch's EditSession against npe_tpu's (plain tail, the path its
own tests take on the CPU) on the same variables and the same script."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.editor.engine import EditSession as JaxSession
from npe_tpu_torch.editor.engine import EditSession as TorchSession
from npe_tpu_torch.ops.kernels.edit_tail import edit_tail
from npe_tpu_torch.ops.kernels.rgb_beta_head import rgb_beta_head
from npe_tpu_torch.ops.kernels.rgb_beta_tail import rgb_beta_tail

tp.torch_threads()


def _image(seed=3):
    return (np.random.RandomState(seed).rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.5


def _sessions(jax_config, torch_config, dim):
    js = JaxSession(config=jax_config, variables=tp.jax_variables(jax_config), dim=dim, use_pallas=False)
    ts = TorchSession(
        config=torch_config, variables=tp.port_variables(jax_config), dim=dim, device="cpu"
    )
    return js, ts


def _assert_same_state(ts, js):
    tp.assert_close(ts.Z.numpy(), np.asarray(js.Z))
    tp.assert_recon_close(ts.RECON, js.RECON)
    tp.assert_im_close(ts.IM, js.IM, ts.RECON, js.RECON)
    tp.assert_recon_close(ts.DELTA, js.DELTA)  # DELTA = xh - RECON
    np.testing.assert_array_equal(ts.USER_MASK, js.USER_MASK)  # same numpy code
    assert len(ts._undo) == len(js._undo) and ts.sample_flag == js.sample_flag


def test_scripted_session_matches_jax():
    js, ts = _sessions(tp.TINY_JAX, tp.TINY_TORCH, (4, 4))
    script = [
        ("infer", (_image(),)),
        ("paint_stroke", (10, 10, 20, 20, (255, 0, 0))),
        ("paint_stroke", (30, 5, 50, 25, (0, 255, 0), 1.5)),
        ("paint_stroke", (0, 40, 12, 64, (0, 0, 255), 0.0)),
        ("scroll_patch", (8, 8, 16, 16, +1)),
        ("set_latents", (np.random.RandomState(4).randn(4, 4).astype(np.float32),)),
        ("undo", ()),
    ]
    for op, args in script:
        getattr(js, op)(*args)
        getattr(ts, op)(*args)
        _assert_same_state(ts, js)
    assert np.abs(ts.DELTA).max() > 1e-2  # the strokes really moved the image

    # fork: shared weights, fresh state; the parent is untouched
    tf, jf = ts.fork(), js.fork()
    assert tf.variables is ts.variables and not tf.can_undo
    z_parent = ts.Z.clone()
    tf.infer(_image(5))
    jf.infer(_image(5))
    _assert_same_state(tf, jf)
    assert torch.equal(ts.Z, z_parent)

    for op in ("reset", "update_gim"):
        getattr(js, op)()
        getattr(ts, op)()
        _assert_same_state(ts, js)


def test_sample_path_skips_the_composite():
    ts = TorchSession(config=tp.TINY_TORCH, variables=tp.port_variables(tp.TINY_JAX), dim=(4, 4), device="cpu")
    ts.infer(_image())
    im = ts.sample(7)
    assert ts.sample_flag
    again = ts.sample(torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(im, again)  # seeded draws are reproducible
    im = ts.paint_stroke(5, 5, 15, 15, (0, 0, 255))
    np.testing.assert_allclose(im, ts.decode_current(), atol=1e-6)  # the raw decode
    ts.undo()
    ts.undo()
    assert ts.sample_flag  # back at the first sample
    ts.undo()
    assert not ts.sample_flag and not ts.can_undo


def test_cpu_session_keeps_the_launch_counter():
    """On the CPU the tail runs the plain version; the counter counts only
    kernel launches, which need a GPU."""
    ts = TorchSession(config=tp.TINY_TORCH, variables=tp.port_variables(tp.TINY_JAX), dim=(4, 4), device="cpu")
    before = edit_tail.launches
    ts.infer(_image())
    ts.paint_stroke(10, 10, 20, 20, (255, 0, 0))
    assert edit_tail.launches == before


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSession(config=tp.TINY_TORCH)


def test_full_width_stroke_matches_jax():
    js, ts = _sessions("IAN_simple", "IAN_simple", (10, 10))
    for s in (js, ts):
        s.infer(_image())
    _assert_same_state(ts, js)
    for s in (js, ts):
        s.paint_stroke(10, 10, 20, 20, (255, 0, 0), 0.5)
    _assert_same_state(ts, js)


# --- IANv1 -------------------------------------------------------------------


def test_ianv1_scripted_session_matches_jax():
    js, ts = _sessions(tp.TINY_V1_JAX, tp.TINY_V1_TORCH, (4, 4))
    script = [
        ("infer", (_image(6),)),
        ("paint_stroke", (10, 10, 20, 20, (255, 0, 0))),
        ("paint_stroke", (30, 5, 50, 25, (0, 255, 0), 1.5)),
        ("scroll_patch", (8, 8, 16, 16, -1)),
        ("set_latents", (np.random.RandomState(7).randn(4, 4).astype(np.float32) * 0.5,)),
        ("undo", ()),
    ]
    for op, args in script:
        getattr(js, op)(*args)
        getattr(ts, op)(*args)
        _assert_same_state(ts, js)
    assert np.abs(ts.DELTA).max() > 1e-2  # the strokes really moved the image

    # sample: the two packages draw different latents, so hand the port's over
    ts.sample(11)
    assert ts.sample_flag and np.abs(ts.IM).max() <= 1.0
    np.testing.assert_allclose(ts.IM, ts.decode_current(), atol=1e-6)
    ts.undo()
    _assert_same_state(ts, js)

    tf, jf = ts.fork(), js.fork()
    assert tf.variables is ts.variables and not tf.can_undo
    z_parent = ts.Z.clone()
    tf.infer(_image(8))
    jf.infer(_image(8))
    _assert_same_state(tf, jf)
    assert torch.equal(ts.Z, z_parent)


def test_ianv1_fused_head_session_matches_the_default():
    """`head_mode` only picks a formulation: the session's results agree,
    the default's ("hybrid") first, and a fork keeps its parent's form."""
    image = _image(9)
    states = []
    for mode in (None, "fused", "plain"):
        ts = TorchSession(config=tp.TINY_V1_TORCH, variables=tp.port_variables(tp.TINY_V1_JAX),
                          dim=(4, 4), device="cpu", head_mode=mode)
        assert ts.fork().decode_options == ({} if mode is None else {"head_mode": mode})
        counts = (rgb_beta_tail.launches, rgb_beta_head.launches, edit_tail.launches)
        ts.infer(image)
        ts.paint_stroke(10, 10, 30, 30, (0, 0, 255), 0.5)
        assert counts == (rgb_beta_tail.launches, rgb_beta_head.launches, edit_tail.launches)  # CPU: no launch
        states.append((ts.Z.numpy(), ts.IM, ts.RECON))
    for z, im, recon in states[1:]:
        tp.assert_close(z, states[0][0])
        tp.assert_recon_close(recon, states[0][2])
        tp.assert_im_close(im, states[0][1], recon, states[0][2])
    with pytest.raises(ValueError, match="unknown RGB-Beta head mode"):
        TorchSession(config=tp.TINY_V1_TORCH, variables=tp.port_variables(tp.TINY_V1_JAX),
                     dim=(4, 4), device="cpu", head_mode="packed").infer(image)


def test_ianv1_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSession(config="IANv1")


def test_full_width_ianv1_stroke_matches_jax():
    js, ts = _sessions("IANv1", "IANv1", (10, 10))
    for s in (js, ts):
        s.infer(_image())
    _assert_same_state(ts, js)
    for s in (js, ts):
        s.paint_stroke(10, 10, 20, 20, (255, 0, 0), 0.5)
    _assert_same_state(ts, js)
    assert np.abs(ts.DELTA).max() > 1e-2
