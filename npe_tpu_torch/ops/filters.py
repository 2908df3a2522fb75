"""Gaussian blur matching `scipy.ndimage.gaussian_filter` (sampled Gaussian,
truncate=4.0, 'reflect' boundary), as npe_tpu's `ops/filters.py` does."""

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma, truncate=4.0):
    """scipy.ndimage._gaussian_kernel1d: sampled pdf, normalized."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    return (phi / phi.sum()).astype(np.float32), radius


def reflect_index(j, n):
    """scipy's 'reflect' boundary (d c b a | a b c d | d c b a), folded as
    often as a radius wider than n needs."""
    while j < 0 or j >= n:
        if j < 0:
            j = -j - 1
        if j >= n:
            j = 2 * n - j - 1
    return j


def gaussian_blur_2d(img, sigma=0.7, truncate=4.0):
    """Blur an (H, W) tensor; matches scipy.ndimage.gaussian_filter(img,
    sigma) with mode='reflect'."""
    k, r = gaussian_kernel_1d(sigma, truncate)
    h, w = img.shape
    rows = torch.tensor([reflect_index(i, h) for i in range(-r, h + r)], device=img.device)
    cols = torch.tensor([reflect_index(j, w) for j in range(-r, w + r)], device=img.device)
    p = img[rows][:, cols][None, None]
    k = torch.from_numpy(k).to(img.device, img.dtype)
    # The Gaussian is symmetric, so correlation == convolution.
    p = F.conv2d(p, k.view(1, 1, -1, 1))
    p = F.conv2d(p, k.view(1, 1, 1, -1))
    return p[0, 0]
