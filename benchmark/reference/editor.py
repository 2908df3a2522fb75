"""One brush stroke of the Neural Photo Editor in plain PyTorch
(`NPE.py:167-235` of the published code): the gradient with respect to z of
the mean squared distance between the decoded image and the colour over the
brush's box (feathered by the `gk` Gaussian when sigma > 0), the step
z - 0.05 g (1 + (c2 - c1)), the decode, and the shown image: DELTA = decode -
RECON, a mask of mean |DELTA| blurred by a Gaussian (sigma 0.7, truncate 4,
reflected edges) plus the user's mask, clipped, and the composite
RECON + mask DELTA + (1 - mask) ERROR."""

import numpy as np
import torch

PAINT_WEIGHT, MASK_SIGMA, TRUNCATE = 0.05, 0.7, 4.0


def brush_mask(h, w, box, sigma, device):
    """1 inside the box [r1, r2) x [c1, c2); outside it exp(-(dx^2 + dy^2) /
    (2 sigma^2 h)) of the distances past its edges, or 0 when sigma is 0."""
    c1, r1, c2, r2 = box
    rows = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    if sigma == 0:
        return ((rows >= r1) & (rows < r2) & (cols >= c1) & (cols < c2)).to(torch.float32)
    dx = torch.clamp(torch.maximum(c1 - cols, cols - (c2 - 1)), min=0.0)
    dy = torch.clamp(torch.maximum(r1 - rows, rows - (r2 - 1)), min=0.0)
    return torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma ** 2 * h))


def blur_operator(n, device, sigma=MASK_SIGMA, truncate=TRUNCATE):
    """(n, n) matrix of the sampled, normalised 1-D Gaussian with reflected
    edges (d c b a | a b c d | d c b a)."""
    radius = int(truncate * sigma + 0.5)
    taps = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    taps /= taps.sum()
    m = np.zeros((n, n))
    for i in range(n):
        for t in range(-radius, radius + 1):
            j = i + t
            while j < 0 or j >= n:
                j = -j - 1 if j < 0 else 2 * n - j - 1
            m[i, j] += taps[t + radius]
    return torch.tensor(m, dtype=torch.float32, device=device)


def stroke(model, v, z, recon, error, user_mask, box, sigma, rgb_tanh, composite=True):
    """The stroke from latents z (zdim,), RECON and ERROR (H, W, 3), the
    user's mask (H, W): (new z, the shown image (3, H, W), DELTA (3, H, W))."""
    h, w = recon.shape[:2]
    rgb = torch.as_tensor(np.asarray(rgb_tanh, np.float32), device=z.device)
    with torch.enable_grad():
        zl = z.detach().clone().requires_grad_(True)
        xh = model.decode(v, zl[None])[0].permute(1, 2, 0)
        m = brush_mask(h, w, box, sigma, z.device)
        loss = (((rgb - xh) ** 2) * m[:, :, None]).sum() / (m.sum() * xh.shape[2])
        (g,) = torch.autograd.grad(loss, zl)
    with torch.no_grad():
        z2 = z - PAINT_WEIGHT * g * (1.0 + (box[2] - box[0]))
        xh2 = model.decode(v, z2[None])[0].permute(1, 2, 0)
        delta = xh2 - recon
        bm = blur_operator(h, z.device)
        mask = bm @ torch.clamp(delta.abs().mean(dim=-1), max=1.0) @ bm.T
        mask = torch.clamp(mask + user_mask, 0.0, 1.0)[:, :, None]
        shown = recon + mask * delta + (1.0 - mask) * error if composite else xh2
    return z2, shown.permute(2, 0, 1), delta.permute(2, 0, 1)
