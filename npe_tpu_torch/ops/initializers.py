"""Weight initializers matching the reference's Lasagne inits.

Each draws from an explicit `torch.Generator`. The distributions are
npe_tpu's; the values cannot be (the two frameworks' generators differ), so
code that needs npe_tpu's exact weights carries them across with
`utils.checkpoints.from_reference`.
"""

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
