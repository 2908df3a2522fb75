"""The edit_tail wrapper and its plain version against npe_tpu's Pallas
kernel (interpret mode) and its reference, on the CPU. The CUDA kernel
itself is held to the plain version on the GPU by `chip_smoke.py` and by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from npe_tpu.ops.pallas import editor_kernels as jk
from npe_tpu_torch.ops.kernels import edit_tail as tk

tp.torch_threads()


def _inputs(seed, batch=None, user_mask="random"):
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    xh = rng.rand(*lead, 64, 64, 3).astype(np.float32) * 2 - 1
    recon = rng.rand(*lead, 64, 64, 3).astype(np.float32) * 2 - 1
    err = rng.rand(*lead, 64, 64, 3).astype(np.float32) * 0.2
    um = {
        None: None,
        "random": rng.rand(*lead, 64, 64).astype(np.float32) * 0.5,
        "ones": np.ones((*lead, 64, 64), np.float32),
    }[user_mask]
    return xh, recon, err, um


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("sigma", [0.7, 1.5])
def test_blur_matrix_equals_jax(sigma):
    # The same float32 accumulation over the same folded indices: exact.
    np.testing.assert_array_equal(
        tk.blur_matrix(64, sigma).numpy(), np.asarray(jk.blur_matrix(64, sigma))
    )


@pytest.mark.parametrize("sigma", [0.7, 1.5])
@pytest.mark.parametrize("user_mask", [None, "random", "ones"])
def test_plain_matches_pallas_interpret_and_reference(user_mask, sigma):
    xh, recon, err, um = _inputs(1, user_mask=user_mask)
    got = tk.edit_tail(_t(xh), _t(recon), _t(err), _t(um), sigma).numpy()
    args = [jnp.asarray(a) for a in (xh, recon, err)]
    jum = None if um is None else jnp.asarray(um)
    pallas = np.asarray(jk.edit_tail(*args, jum, sigma, interpret=True))
    ref = np.asarray(jk.edit_tail_reference(*args, jk.blur_matrix(64, sigma), jum))
    tp.assert_close(got, pallas)
    tp.assert_close(got, ref)
    if user_mask == "ones":  # a saturated floor shows the decode itself
        tp.assert_close(got, xh)


def test_batch_equals_each_image():
    xh, recon, err, um = _inputs(2, batch=3)
    out = tk.edit_tail(_t(xh), _t(recon), _t(err), _t(um))
    for i in range(3):
        one = tk.edit_tail(_t(xh[i]), _t(recon[i]), _t(err[i]), _t(um[i]))
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_leave_the_launch_counter_unchanged():
    before = tk.edit_tail.launches
    xh, recon, err, um = _inputs(3)
    tk.edit_tail(_t(xh), _t(recon), _t(err), _t(um))
    assert tk.edit_tail.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xh, recon, err, um = (_t(a) for a in _inputs(4))
    with pytest.raises(ValueError, match="contiguous"):
        tk.edit_tail(xh.transpose(0, 1), recon, err, um)
    with pytest.raises(TypeError, match="float32"):
        tk.edit_tail(xh.double(), recon.double(), err.double(), um.double())
    with pytest.raises(ValueError, match="images"):
        tk.edit_tail(xh[:, :32], recon[:, :32], err[:, :32])
    with pytest.raises(ValueError, match="user_mask"):
        tk.edit_tail(xh, recon, err, um[:32])
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(128, 128, 3)
        tk.edit_tail(big, big, big)
