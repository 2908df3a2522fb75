"""Validation evaluation (npe_tpu `training/evaluate.py`), the legacy
training script's validation-MSE loop (reference `train_IAN_simple.py:759-800`):
deterministic encode/decode over the validation set with the two half-batch
offsets, reporting pixel accuracy (1 - MSE)."""

import torch

from npe_tpu_torch.data import data_loader
from npe_tpu_torch.training.programs import EvalPrograms


def validation_pixel_accuracy(module, variables, dataset, cfg, max_chunks=None, programs=None):
    """Returns dict(test_error=float pixel accuracy in [0,1], mse=float).
    Each batch is one run of the `recon_mse` program of `programs`, an
    `EvalPrograms` that holds `variables` (None makes one on their device for
    the call); each chunk goes up once, and the per-batch errors come to the
    host once, at the end."""
    if programs is None:
        programs = EvalPrograms.of(module, variables)
    bs = cfg["batch_size"]
    # clamp the chunk size so validation sets smaller than a training chunk
    # still produce at least one chunk
    vcfg = dict(cfg)
    vcfg["batches_per_chunk"] = max(1, min(cfg["batches_per_chunk"], dataset.num_examples // bs - 1))
    errs = []
    for o in range(2):
        loader = data_loader(vcfg, dataset, offset=o * bs // 2)
        for ci, chunk in enumerate(loader):
            if max_chunks is not None and ci >= max_chunks:
                break
            x_dev = torch.from_numpy(chunk).to(programs.device)
            for bi in range(len(chunk) // bs):
                errs.append(programs("recon_mse", x_dev[bi * bs : (bi + 1) * bs]))
    mse = float(torch.stack(errs).mean()) if errs else float("nan")
    return {"test_error": 1.0 - mse, "mse": mse}
