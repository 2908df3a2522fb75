"""Helpers shared by the port's parity tests (`tests/test_torch_*.py`): the
same variables, made by npe_tpu's `init(jax.random.PRNGKey(0))`, go through
npe_tpu and, carried across with `from_reference`, through npe_tpu_torch."""

import numpy as np
import jax
import torch

from npe_tpu.models import get_config as jax_config
from npe_tpu_torch.utils.checkpoints import from_reference, unit_gain

TINY_JAX = "tests/tiny_ian.py"
TINY_TORCH = "tests/tiny_ian_torch.py"
TINY_V1_JAX = "tests/tiny_ianv1.py"
TINY_V1_TORCH = "tests/tiny_ianv1_torch.py"
# The golden tolerance, tests/test_goldens.py:28-29.
RTOL, ATOL = 1e-3, 1e-4
# What the seeded weights multiply the IAF's log-sigma output layers by.
IAF_LOGSIGMA_GAIN = 0.1
# One step of the uint8 grid in tanh units (the editor's RECON quantization).
UINT8_STEP = 2.0 / 255.0

_cache = {}


def jax_variables(config):
    """npe_tpu variables for `config` from PRNGKey(0), unit-gain, as numpy.
    The IAF's log-sigma outputs are damped to IAF_LOGSIGMA_GAIN: at unit gain
    exp(logsigma) would throw latents far outside the decoder's range."""
    if config not in _cache:
        seeded = jax_config(config).init(jax.random.PRNGKey(0))
        _cache[config] = unit_gain(seeded, iaf_logsigma_gain=IAF_LOGSIGMA_GAIN)
    return dict(_cache[config])


def port_variables(config, device="cpu"):
    return from_reference(jax_variables(config), device)


def nhwc(t):
    """A port NCHW tensor -> NHWC numpy, npe_tpu's layout."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a):
    """An npe_tpu NHWC array -> a contiguous port NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# Space-to-depth layouts. npe_tpu packs NHWC maps position-major: channel
# pos*C + c for the in-block pixel pos = p*r + q. Inside its head kernels, and
# everywhere in the port, packed channels are component-major: c*rr + pos.
# The port's maps are NCHW besides, so `nhwc` / `nchw` plus one of the two
# functions below carry any packed map, tap matrix or packed kernel across.


def position_major(a, rr, axis=-1):
    """Reorder `axis` of a numpy array from component-major (c*rr + pos) to
    position-major (pos*C + c)."""
    a = np.moveaxis(np.asarray(a), axis, -1)
    c = a.shape[-1] // rr
    a = a.reshape(a.shape[:-1] + (c, rr)).swapaxes(-1, -2).reshape(a.shape)
    return np.moveaxis(a, -1, axis)


def component_major(a, rr, axis=-1):
    """The inverse of `position_major`."""
    a = np.moveaxis(np.asarray(a), axis, -1)
    c = a.shape[-1] // rr
    a = a.reshape(a.shape[:-1] + (rr, c)).swapaxes(-1, -2).reshape(a.shape)
    return np.moveaxis(a, -1, axis)


def hwio(k):
    """A port conv kernel (cout, cin, kh, kw) tensor -> npe_tpu's HWIO numpy."""
    return k.detach().permute(2, 3, 1, 0).numpy()


def oihw(k):
    """An npe_tpu HWIO conv kernel -> a contiguous port (cout, cin, kh, kw) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def assert_close(actual, desired, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired), rtol=rtol, atol=atol)


def assert_recon_close(actual, desired, atol=ATOL, max_frac=1e-3):
    """RECON passes through uint8 truncation, which turns a 1e-6 difference
    at a quantization boundary into a jump of one uint8 step. Rule: every
    value within atol, except at most `max_frac` of them that differ by
    exactly one step."""
    d = np.abs(np.asarray(actual, np.float64) - np.asarray(desired, np.float64))
    off = d > atol
    assert off.mean() <= max_frac, f"{off.sum()} of {d.size} values differ"
    np.testing.assert_allclose(d[off], UINT8_STEP, atol=atol)


def assert_im_close(actual, desired, recon_actual, recon_desired, atol=ATOL):
    """The editor's composite IM = mask*xh + (1-mask)*x depends on RECON only
    through the mask, m = min(mean_c |xh - RECON|, 1), blurred with radius 3.
    A RECON value one uint8 step apart moves m there by at most step/3, the
    blurred mask by less, and IM, by at most that times |xh - x| <= 2. Rule:
    IM within rtol/atol, except within 3 pixels of a RECON pixel that differs
    by a step, where within step/3 * 2."""
    import scipy.ndimage

    near = np.abs(np.asarray(recon_actual) - np.asarray(recon_desired)).max(axis=0) > atol
    near = scipy.ndimage.binary_dilation(near, structure=np.ones((7, 7), bool))
    a, d = np.asarray(actual), np.asarray(desired)
    assert_close(a[:, ~near], d[:, ~near], atol=atol)
    np.testing.assert_allclose(a[:, near], d[:, near], atol=UINT8_STEP / 3 * 2)


def torch_threads():
    # Tier-1 runs six xdist workers; one intra-op thread each keeps them apart.
    torch.set_num_threads(1)
