"""Validation evaluation (npe_tpu `training/evaluate.py`), the legacy
training script's validation-MSE loop (reference `train_IAN_simple.py:759-800`):
deterministic encode/decode over the validation set with the two half-batch
offsets, reporting pixel accuracy (1 - MSE)."""

import numpy as np
import torch

from npe_tpu_torch.data import data_loader


def validation_pixel_accuracy(module, variables, dataset, cfg, max_chunks=None):
    """Returns dict(test_error=float pixel accuracy in [0,1], mse=float).
    Runs on the device of `variables`; the per-batch errors come to the host
    once, at the end."""
    device = next(iter(variables.values())).device
    bs = cfg["batch_size"]
    # clamp the chunk size so validation sets smaller than a training chunk
    # still produce at least one chunk
    vcfg = dict(cfg)
    vcfg["batches_per_chunk"] = max(1, min(cfg["batches_per_chunk"], dataset.num_examples // bs - 1))
    errs = []
    with torch.no_grad():
        for o in range(2):
            loader = data_loader(vcfg, dataset, offset=o * bs // 2)
            for ci, chunk in enumerate(loader):
                if max_chunks is not None and ci >= max_chunks:
                    break
                x_dev = torch.from_numpy(chunk).to(device)
                for bi in range(len(chunk) // bs):
                    xb = x_dev[bi * bs : (bi + 1) * bs]
                    x_hat = module.decode(variables, module.encode(variables, xb))
                    errs.append(torch.mean((x_hat - xb) ** 2))
    mse = float(torch.stack(errs).mean()) if errs else float("nan")
    return {"test_error": 1.0 - mse, "mse": mse}
