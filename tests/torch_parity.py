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
TINY_FULL_JAX = "tests/tiny_ian_full.py"
TINY_FULL_TORCH = "tests/tiny_ian_full_torch.py"
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


def as_jax(variables):
    """numpy variables -> jax arrays, for the npe_tpu functions that update
    an array with `.at` (the branch-per-scale MDCL of full IAN's MDBLOCKs)."""
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in variables.items()}


def with_bn_state(variables, seed=0):
    """npe_tpu variables with every batch norm's running state and affine
    moved off the identity that init leaves (mean 0, inv_std 1, beta 0,
    gamma 1), so that an inference-mode comparison sees each of the four."""
    rng = np.random.RandomState(seed)
    ranges = {".mean": (-0.2, 0.3), ".inv_std": (0.8, 1.3), ".beta": (-0.1, 0.1), ".gamma": (0.9, 1.1)}
    out = dict(variables)
    for k in sorted(out):
        for suffix, (lo, hi) in ranges.items():
            if k.endswith(suffix) and k[: -len(suffix)] + ".inv_std" in out:
                out[k] = rng.uniform(lo, hi, np.shape(out[k])).astype(np.float32)
    return out


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


# --- training parity ---------------------------------------------------------
#
# Gradients of this network are not continuous in its inputs: every relu and
# LeakyReLU is a kink, and one unit whose pre-activation two float32
# implementations round to opposite sides of zero moves the adversarial and
# feature-matching gradients (sums of about 1e4 contributions of random sign)
# by about 1 % of their largest value, in every tensor at once. With some
# 6e5 such units in a tiny step this happens in roughly every second seeded
# batch, between npe_tpu and the port and just as well between either and its
# own float64 run. So the gradient comparisons run both packages in float64
# (`x64()` for JAX), where the same units are 1e-9 times as likely to flip and
# the two agree to 1e-7 (npe_tpu computes the losses from float32 casts of the
# forward's outputs); float32 comparisons cover what is continuous: the
# forward, the losses, the metrics and the BN statistics.


def x64():
    """Context manager: JAX with float64 enabled, for this block only."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64

    return enable_x64()


def training_batch(cfg, n=4, seed=0, dtype=np.float32):
    """(x NHWC in [-1, 1], z_rand, PRNG key, eps): n procedural faces, and
    the reparameterization noise npe_tpu's `sample_latent` draws from `key`
    for an (n, num_latents) mu of `dtype`. Call under `x64()` for float64."""
    import jax.numpy as jnp

    from npe_tpu.data import SyntheticFaces

    rng = np.random.RandomState(seed)
    faces = SyntheticFaces(64).get_data(rng.choice(64, n, replace=False))
    x = (faces.astype(dtype).transpose(0, 2, 3, 1) / dtype(127.5) - 1).astype(dtype)
    z = rng.randn(n, cfg["num_latents"]).astype(dtype)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, z.shape, jnp.dtype(dtype)))
    assert eps.dtype == dtype
    return x, z, key, eps


def plain_head(module):
    """The port's `module` with its RGB-Beta head in the plain form, for
    float64 runs (the hybrid head's kernel wrapper takes float32 only)."""
    import types

    ns = types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module) if not k.startswith("__")})
    if module.HAS_IAF:
        ns.decode = lambda v, z, train=False, upd=None: module.decode(v, z, train, upd, head_mode="plain")
        ns.decode_pre_iaf = lambda v, z, train=False, upd=None: module.decode_pre_iaf(
            v, z, train, upd, head_mode="plain")
    return ns


def assert_grads_close(actual, desired, rtol=1e-5, atol_of_largest=1e-6, floor=1e-8):
    """Dicts of gradients in npe_tpu's layouts: each tensor within rtol and
    `atol_of_largest` of its own largest value (+ `floor`: a gradient that
    is zero in exact arithmetic comes out as rounding noise of either side's
    float32 loss, about 2e-9)."""
    assert sorted(actual) == sorted(desired)
    for k, want in desired.items():
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(actual[k]), want, rtol=rtol,
                                   atol=atol_of_largest * np.abs(want).max() + floor, err_msg=k)
