"""Batch normalization with explicit running-statistics state.

Lasagne's conventions, as npe_tpu keeps them for checkpoint parity: the
running state is `mean` and `inv_std` (not a variance), eps 1e-4, and an
exponential moving average with alpha 0.1 on both. `nn.BatchNorm2d` and
`F.batch_norm` keep a running variance instead and drift from this after one
training step, so this is a function over the flat dict.
"""

import torch

EPS = 1e-4
ALPHA = 0.1


def batch_norm_apply(x, beta, gamma, mean, inv_std, train):
    """Returns (y, (new_mean, new_inv_std)); x is (N, C) or (N, C, H, W).

    train=True: normalize with batch statistics (biased variance),
    EMA-update the running stats. train=False: normalize with the running
    stats and pass them through unchanged.

    Mixed precision, as npe_tpu (`ops/norm.py:batch_norm_apply`): when the
    activations are in another dtype than the running stats (a bf16 forward
    over float32 state), the batch statistics and the normalization run in
    the stats' dtype and the result returns in the activations'. A call of
    one dtype throughout (float32, or bf16 after a bf16 cast) is unchanged."""
    axes = (0,) if x.ndim == 2 else (0, 2, 3)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        xs = x.to(mean.dtype)
        mu = xs.mean(dim=axes)
        var = xs.var(dim=axes, unbiased=False)
        istd = torch.rsqrt(var + EPS)
        y = (xs - mu.view(shape)) * (gamma.to(mu.dtype) * istd).view(shape) + beta.to(mu.dtype).view(shape)
        y = y.to(x.dtype)
        new_mean = (1 - ALPHA) * mean + ALPHA * mu
        new_inv_std = (1 - ALPHA) * inv_std + ALPHA * istd
        return y, (new_mean, new_inv_std)
    y = (x - mean.view(shape)) * (gamma * inv_std).view(shape) + beta.view(shape)
    return y, (mean, inv_std)
