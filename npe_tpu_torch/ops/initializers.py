"""Weight initializers matching the reference's Lasagne inits.

Each draws from an explicit `torch.Generator`. The distributions are
npe_tpu's; the values cannot be (the two frameworks' generators differ), so
code that needs npe_tpu's exact weights carries them across with
`utils.checkpoints.from_reference`.
"""

import math

import torch


def normal(std=0.01, mean=0.0):
    """Lasagne Normal(std): N(mean, std^2). NOTE: Lasagne's arg is the std.
    Draws on the generator's device, then moves to `device`."""

    def init(gen, shape, device, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
        return (mean + std * x).to(device)

    return init


def constant(val=0.0):
    def init(gen, shape, device, dtype=torch.float32):
        return torch.full(shape, val, dtype=dtype, device=device)

    return init


def orthogonal(gain=1.0):
    """Lasagne Orthogonal(gain); gain='relu' means sqrt(2). A Gaussian matrix
    from the generator, then the orthonormal factor of its SVD."""
    if gain == "relu":
        gain = math.sqrt(2.0)

    def init(gen, shape, device, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError("orthogonal init needs >=2 dims")
        flat = (shape[0], math.prod(shape[1:]))
        a = torch.randn(flat, generator=gen, dtype=torch.float32, device=gen.device)
        u, _, vt = torch.linalg.svd(a, full_matrices=False)
        q = u if tuple(u.shape) == flat else vt
        return (gain * q.reshape(shape)).to(device=device, dtype=dtype)

    return init
