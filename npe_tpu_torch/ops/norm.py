"""Batch normalization with explicit running-statistics state.

Lasagne's conventions, as npe_tpu keeps them for checkpoint parity: the
running state is `mean` and `inv_std` (not a variance), eps 1e-4, and an
exponential moving average with alpha 0.1 on both. `nn.BatchNorm2d` and
`F.batch_norm` keep a running variance instead and drift from this after one
training step, so this is a function over the flat dict.
"""

import torch

from npe_tpu_torch.parallel.collectives import active, all_reduce_sum

EPS = 1e-4
ALPHA = 0.1


def batch_norm_apply(x, beta, gamma, mean, inv_std, train, axis=None):
    """Returns (y, (new_mean, new_inv_std)); x is (N, C) or (N, C, H, W).

    train=True: normalize with batch statistics (biased variance),
    EMA-update the running stats. train=False: normalize with the running
    stats and pass them through unchanged.

    Mixed precision, as npe_tpu (`ops/norm.py:batch_norm_apply`): when the
    activations are in another dtype than the running stats (a bf16 forward
    over float32 state), the batch statistics and the normalization run in
    the stats' dtype and the result returns in the activations'. A call of
    one dtype throughout (float32, or bf16 after a bf16 cast) is unchanged.

    `axis` (a data axis of `parallel.collectives`): x holds this rank's rows
    of a global batch, and the statistics are the global batch's, in two
    passes summed over the axis: the mean, then the squared deviations from
    it. Every rank gets the same statistics and running-state updates."""
    axes = (0,) if x.ndim == 2 else (0, 2, 3)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        xs = x.to(mean.dtype)
        if not active(axis):
            mu = xs.mean(dim=axes)
            var = xs.var(dim=axes, unbiased=False)
        else:
            count = xs.numel() // xs.shape[1] * axis.size
            mu = all_reduce_sum(xs.sum(dim=axes), axis) / count
            var = all_reduce_sum(((xs - mu.view(shape)) ** 2).sum(dim=axes), axis) / count
        istd = torch.rsqrt(var + EPS)
        y = (xs - mu.view(shape)) * (gamma.to(mu.dtype) * istd).view(shape) + beta.to(mu.dtype).view(shape)
        y = y.to(x.dtype)
        new_mean = (1 - ALPHA) * mean + ALPHA * mu
        new_inv_std = (1 - ALPHA) * inv_std + ALPHA * istd
        return y, (new_mean, new_inv_std)
    y = (x - mean.view(shape)) * (gamma * inv_std).view(shape) + beta.view(shape)
    return y, (mean, inv_std)


def batch_renorm_apply(x, beta, gamma, mean, inv_std, rmax, dmax, train):
    """Batch ReNormalization (npe_tpu `ops/norm.py:batch_renorm_apply`,
    reference `layers.py:48-130`). Returns (y, (new_mean, new_inv_std)).
    rmax / dmax are the annealing clips the training loop manages
    (`renorm_schedule`); the corrections r and d carry no gradient."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if not train:
        y = (x - mean.view(shape)) * (gamma * inv_std).view(shape) + beta.view(shape)
        return y, (mean, inv_std)
    axes = (0,) if x.ndim == 2 else (0, 2, 3)
    mu = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    istd = torch.rsqrt(var + EPS)
    with torch.no_grad():
        r = torch.clamp(inv_std / istd, 1.0 / rmax, rmax)
        d = torch.clamp((mu - mean) * inv_std, -dmax, dmax)
    xhat = (x - mu.view(shape)) * (istd * r).view(shape) + d.view(shape)
    y = gamma.view(shape) * xhat + beta.view(shape)
    new_mean = (1 - ALPHA) * mean + ALPHA * mu
    new_inv_std = (1 - ALPHA) * inv_std + ALPHA * istd
    return y, (new_mean, new_inv_std)


def renorm_schedule(itr, rmax_max=3.0, dmax_max=5.0, ramp_start=1000, ramp_end=5000):
    """RMAX / DMAX annealing for `batch_renorm_apply` (npe_tpu
    `ops/norm.py:renorm_schedule`): identity clips (r = 1, d = 0) until
    `ramp_start` iterations, then a linear ramp to (rmax_max, dmax_max) by
    `ramp_end` (arXiv 1702.03275 section 3, with the reference's faster
    ramp, `layers.py:38-45`). `itr` a Python int gives Python floats, a
    tensor gives tensors."""
    frac = (itr - ramp_start) / max(1, ramp_end - ramp_start)
    frac = torch.clamp(frac, 0.0, 1.0) if isinstance(frac, torch.Tensor) else min(max(frac, 0.0), 1.0)
    return 1.0 + frac * (rmax_max - 1.0), frac * dmax_max
