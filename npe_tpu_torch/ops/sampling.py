"""VAE reparameterization sampling (npe_tpu `ops/sampling.py`, reference
`GaussianSampleLayer`, `layers.py:419-433`): z = mu + exp(logsigma) * eps.

The noise is explicit: a tensor of mu's shape, or a `torch.Generator` on
mu's device from which it is drawn. None returns mu (deterministic=True).
Either way eps takes mu's dtype, as npe_tpu draws it in mu's dtype: a bf16
training forward samples in bf16.
"""

import torch


def gaussian_sample(mu, logsigma, noise=None):
    """`noise`: None (returns mu), the eps tensor itself, or a
    torch.Generator to draw eps from."""
    if noise is None:
        return mu
    if isinstance(noise, torch.Generator):
        noise = torch.randn(mu.shape, generator=noise, dtype=mu.dtype, device=mu.device)
    elif noise.shape != mu.shape:
        raise ValueError(f"noise has shape {tuple(noise.shape)}, mu {tuple(mu.shape)}")
    else:
        noise = noise.to(mu.dtype)
    return mu + torch.exp(logsigma) * noise


# GSL (`layers.py:615-628`) is shape-generic already; alias for inventory.
gaussian_sample_spatial = gaussian_sample


def gaussian_sample_list(mus, logsigmas, noise=None):
    """`GL` (`layers.py:631-632`): list of sampled latent tensors. `noise`:
    None, one Generator for all, or a list of eps tensors."""
    if noise is None or isinstance(noise, torch.Generator):
        return [gaussian_sample(m, ls, noise) for m, ls in zip(mus, logsigmas)]
    return [gaussian_sample(m, ls, e) for m, ls, e in zip(mus, logsigmas, noise)]
