"""Sample / reconstruction / interpolation grids (npe_tpu
`training/eval_grids.py`), the reference's qualitative regression artifact
(`train_IAN.py:536-561`, `sample_IAN.py:171-191`): 27 random samples + 3 rows
of [endpoint, 7-step latent lerp, endpoint] laid out as a 6x9 grid."""

import numpy as np

from npe_tpu_torch.training.programs import EvalPrograms
from npe_tpu_torch.utils.plotting import plot_image_grid
from npe_tpu_torch.utils.ranges import from_tanh, to_tanh


def sample_and_interp_grid(module, variables, dataset, save_path, seed=0, programs=None):
    """Writes the grid to `save_path` as a picture and returns its
    (54, 3, 64, 64) uint8 images. Its two decodes and its encode run as
    programs of `programs`, an `EvalPrograms` that holds `variables` (the
    trainer loads its owner once a checkpoint); None makes one on the device
    of `variables` for the call."""
    if programs is None:
        programs = EvalPrograms.of(module, variables)
    rng = np.random.RandomState(seed)
    zdim = module.cfg["num_latents"]

    def decode_u8(z):
        return np.uint8(np.clip(from_tanh(programs("decode_pre_iaf", z, download=True)), 0, 255))

    # 27 random samples through the pre-IAF entry point (`train_IAN.py:543`)
    samples = decode_u8(rng.randn(27, zdim).astype(np.float32))

    # 6 endpoints from the dataset (`train_IAN.py:548`)
    endpoints = np.uint8(dataset.get_data(rng.choice(dataset.num_examples, 6, replace=False)))
    ze = programs("encode_pre_iaf", to_tanh(np.float32(endpoints)), download=True)

    # 7-step lerp per pair (`train_IAN.py:554`)
    z_interp = np.asarray(
        [ze[2 * i] * (1 - j) + ze[2 * i + 1] * j for i in range(3) for j in [k / 6.0 for k in range(7)]],
        dtype=np.float32,
    )
    recon = decode_u8(z_interp)

    rows = [
        np.concatenate([endpoints[2 * i : 2 * i + 1], recon[7 * i : 7 * (i + 1)], endpoints[2 * i + 1 : 2 * i + 2]])
        for i in range(3)
    ]
    images = np.concatenate([samples] + rows)
    plot_image_grid(images, 6, 9, save_path)
    return images
