"""Seeded 64x64 faces made on the device in a few batched calls: a
background gradient, a skin oval, two eyes and a mouth, as the program's
`data.datasets.SyntheticFaces` draws them one by one on the host. The same
seed gives the same faces on the same device."""

import numpy as np
import torch


def seeds(seed, n):
    """`n` 31-bit seeds derived from `seed` (any whole number)."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n, np.uint32) >> 1]


def faces_uint8(n, seed, device, size=64):
    """(n, 3, size, size) uint8 faces, NCHW."""
    g = torch.Generator(device).manual_seed(seeds(seed, 1)[0])
    u = torch.rand((n, 24), generator=g, device=device)
    yy = (torch.arange(size, device=device, dtype=torch.float32) / size)[None, :, None]
    xx = (torch.arange(size, device=device, dtype=torch.float32) / size)[None, None, :]

    def col(i):
        return u[:, i].view(n, 1, 1)

    bg = u[:, 0:6].view(n, 3, 2, 1, 1)
    img = bg[:, :, 0] * (1 - yy[:, None]) + bg[:, :, 1] * yy[:, None]  # (n, 3, size, size)
    cx, cy = 0.5 + 0.1 * (col(6) - 0.5), 0.5 + 0.1 * (col(7) - 0.5)
    rx, ry = 0.28 + 0.08 * col(8), 0.36 + 0.08 * col(9)
    oval = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1.0
    skin = 0.55 + 0.3 * u[:, 10:13]
    skin = skin * torch.tensor([1.0, 1.0, 0.8], device=device)
    img = torch.where(oval[:, None], skin.view(n, 3, 1, 1), img)
    for k, ex in enumerate((cx - 0.12, cx + 0.12)):
        eye = ((xx - ex) / 0.045) ** 2 + ((yy - (cy - 0.08)) / 0.03) ** 2 < 1.0
        img = torch.where(eye[:, None], (0.1 + 0.1 * col(13 + k))[:, None], img)
    mouth = (((xx - cx) / 0.12) ** 2 + ((yy - (cy + 0.18)) / 0.035) ** 2 < 1.0)[:, None]
    lips = torch.cat([0.6 + 0.3 * col(15)[:, None], torch.full((n, 1, 1, 1), 0.2, device=device),
                      torch.full((n, 1, 1, 1), 0.25, device=device)], dim=1)
    img = torch.where(mouth, lips, img)
    return (img.clamp(0, 1) * 255).to(torch.uint8).contiguous()


def to_tanh(u8):
    """uint8 images to float32 in [-1, 1], as the program stages them."""
    return u8.to(torch.float32) * (2.0 / 255.0) - 1.0
