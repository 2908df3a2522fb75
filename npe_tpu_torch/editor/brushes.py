"""Optional neural-painter brush helpers (npe_tpu `editor/brushes.py`).

The smoothing and saturation heuristics the reference defines but leaves
unwired in its main paint path (`NPE.py:163-189`). The *wired* soft brush is
`npe_tpu_torch.api.soft_patch_mask` (on the device) and
`engine._soft_box_profile` (its host twin); `gk` here is the host-side
3-channel variant of the same separable distance-ramp Gaussian, kept so users
of the reference find the helper under its original name. numpy only.
"""

import numpy as np


def _axis_ramp(n, lo, hi):
    """Per-index distance to the half-open interval [lo, hi): 0 inside,
    1 at the first index past either edge, growing linearly outward."""
    idx = np.arange(n, dtype=np.float64)
    return np.maximum(np.maximum(lo - idx, idx - (hi - 1)), 0.0)


def gk(c1, r1, c2, r2, im=64, sigma=0.3):
    """Gaussian falloff centred on the brush box [r1:r2, c1:c2] of an
    (im, im) canvas: 1 inside the box, decaying with squared distance to it,
    normalised by the canvas size so sigma is resolution-independent.
    Matches the output of the reference's localizer (`NPE.py:167-175`).
    Returns (3, im, im), one copy per RGB channel."""
    dc = _axis_ramp(im, c1, c2)
    dr = _axis_ramp(im, r1, r2)
    # Separable: exp(-(dc^2 + dr^2) / (2 sigma^2 im)) as an outer product.
    col_g = np.exp(-(dc**2) / (2.0 * sigma**2 * im))
    row_g = np.exp(-(dr**2) / (2.0 * sigma**2 * im))
    g = row_g[:, None] * col_g[None, :]
    return np.broadcast_to(g, (3, im, im)).copy()


def upperlim(image, h=1.0):
    """Change-likelihood attenuation near saturated pixel values
    (`NPE.py:179-181`): 1 at mid-gray (128), falling off hyperbolically
    with distance from it; h sets the half-attenuation distance."""
    return h / (h + np.abs(np.asarray(image, dtype=np.float64) - 128.0))


def dampen(input, correct, thresh=0.75):
    """Clamp a proposed correction so input + correction never exceeds
    thresh (`NPE.py:184-189`): where it would, return the largest allowed
    step (thresh - input); elsewhere pass the correction through."""
    input = np.asarray(input)
    correct = np.asarray(correct)
    return np.where(input + correct > thresh, thresh - input, correct)
