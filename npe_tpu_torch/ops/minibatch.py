"""Minibatch discrimination (npe_tpu `ops/minibatch.py`, reference
`layers.py:486-524`).

Output features f_i[k] = sum_j exp(-||a_i[k] - a_j[k]||_1) + b[k], appended to
the input features. The self term is masked with a 1e6 offset as the
reference does (it contributes exp(-1e6) = 0).

The (N, K, D, N) difference tensor is the large intermediate: 164 MB in
float32 at N = 128, K = 500, D = 5.
"""

import torch


def minibatch_discrimination(x, theta, log_weight_scale, b):
    """x: (N, F) [or flattened]; theta: (F, K, D); log_weight_scale: (K, D);
    b: (K,). Returns (N, F + K)."""
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    # Normalize kernels: W = theta * exp(lws) / ||theta||_2 over inputs.
    w = theta * (torch.exp(log_weight_scale) / torch.sqrt((theta**2).sum(dim=0)))[None]
    act = torch.tensordot(x, w, dims=([1], [0]))  # (N, K, D)
    # L1 distance across samples: (N, K, N)
    abs_dif = (act[:, :, :, None] - act.permute(1, 2, 0)[None]).abs().sum(dim=2)
    n = x.shape[0]
    abs_dif = abs_dif + 1e6 * torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :]
    f = torch.exp(-abs_dif).sum(dim=2) + b
    return torch.cat([x, f], dim=1)
