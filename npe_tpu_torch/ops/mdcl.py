"""Multiscale Dilated Convolution (MDC), composed and branch-per-scale forms
(npe_tpu `ops/mdcl.py:25-95`).

The reference's `MDCL` block (`layers.py:207-258`) runs one shared 3x3 filter
W through several parallel conv layers -- an undilated 3x3, a 1x1 conv of the
filter means, and one dilated 3x3 per scale -- each scaled by a learned
per-output-channel coefficient, then sums the branch outputs. A sum of
convolutions over a shared input is one convolution with the summed (sparse,
multiscale) kernel, so the block composes ONE kernel of size
3 + 2*(max_scale - 1) and runs one conv. Filters are in the port's layout,
(nf, ni, 3, 3).
"""

import functools

import numpy as np
import torch

from npe_tpu_torch.ops.conv import conv2d


def mdcl_kernel_size(scales):
    smax = max([s for s in scales if s > 0] + [1])
    return 3 + 2 * (smax - 1)


@functools.lru_cache(maxsize=32)
def _placement(scales, device):
    """(B*9, size*size) 0/1 (and 1/9) matrix that places the 9 taps of each
    of the B = 1 + len(scales) branches into the composed kernel: branch 0
    the undilated 3x3 at the centre, then one branch per scale (scale 0: the
    mean of the taps on the centre tap; scale s >= 1: dilation s). Built once
    per (scales, device)."""
    size = mdcl_kernel_size(scales)
    c = size // 2
    p = np.zeros((1 + len(scales), 3, 3, size, size), np.float32)
    for b, s in enumerate((1,) + scales):
        for i in range(3):
            for j in range(3):
                if b > 0 and s == 0:
                    p[b, i, j, c, c] = 1.0 / 9.0
                else:
                    p[b, i, j, c + (i - 1) * s, c + (j - 1) * s] = 1.0
    return torch.from_numpy(p.reshape(-1, size * size)).to(device)


def compose_mdcl_kernel(w, coeff_base, scale_coeffs, scales):
    """Build the combined multiscale kernel (additive branch semantics).

    w: (nf, ni, 3, 3) shared base filter.
    coeff_base: (nf,) coefficient of the undilated 3x3 branch.
    scale_coeffs: dict {scale: (nf,)}; scale 0 is the 1x1 mean-filter branch
    (reference `layers.py:238-247`), scale s>=1 the dilation-s branch.
    Returns (nf, ni, size, size). Where npe_tpu adds each branch into a slice
    of a zero kernel, this is one product of the coefficient-scaled taps with
    a constant placement matrix: two launches instead of a dozen, and the
    same sums."""
    nf, ni = w.shape[:2]
    size = mdcl_kernel_size(scales)
    coeffs = torch.stack([coeff_base] + [scale_coeffs[s] for s in scales], dim=1)  # (nf, B)
    scaled = w.reshape(nf, ni, 1, 9) * coeffs[:, None, :, None]
    big = scaled.reshape(nf, ni, -1) @ _placement(tuple(scales), w.device).to(w.dtype)
    return big.reshape(nf, ni, size, size)


def mdcl_apply(x, w, coeff_base, scale_coeffs, scales):
    """The whole MDCL block ('same' padding) as one conv with the composed
    kernel. (npe_tpu picks between this and `mdcl_apply_branch` per scale set
    from a TPU tuning switch; the port's models always take this form.)"""
    k = compose_mdcl_kernel(w, coeff_base, scale_coeffs, scales)
    return conv2d(x, k, padding=k.shape[-1] // 2)


def mdcl_apply_branch(x, w, coeff_base, scale_coeffs, scales):
    """Branch-per-scale MDCL (npe_tpu `ops/mdcl.py:81-95`): the base 3x3 with
    the scale-0 branch (the 1x1 conv of the filter means) folded into its
    centre tap, plus one dilation-s 3x3 conv per scale s > 0, the
    per-output-channel coefficients folded into the kernels. The same sums as
    `mdcl_apply` without the composed kernel's structural zeros."""
    k3 = w * coeff_base[:, None, None, None]
    if 0 in scales:
        centre = torch.zeros(3, 3, dtype=w.dtype, device=w.device)
        centre[1, 1] = 1.0
        k3 = k3 + (w.mean(dim=(2, 3)) * scale_coeffs[0][:, None])[:, :, None, None] * centre
    out = conv2d(x, k3, padding=1)
    for s in scales:
        if s > 0:
            out = out + conv2d(x, w * scale_coeffs[s][:, None, None, None], padding=s, dilation=s)
    return out
