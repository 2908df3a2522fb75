"""Sample-quality metric (npe_tpu `training/quality.py`): the Frechet
distance between encoder-feature distributions of real and generated images
("encoder-FID").

A classic FID needs an InceptionV3 checkpoint; the IAN's own encoder tower
stands in for it: its GlobalPool(enc_conv4) features define the
feature-matching loss the generator trains against (reference
`train_IAN.py:244`), so a Frechet distance in that space tracks the same
notion of realism the objective uses. Lower is better; it is comparable
across checkpoints OF THE SAME encoder (pass a fixed `feature_variables`).

CLI: python -m npe_tpu_torch.training.quality <config> [--dataset ...] [--num N]
prints one JSON line {"metric": "encoder_fid", "value": ..., "num": ...}.
"""

import numpy as np
import torch

from npe_tpu_torch.ops.conv import global_avg_pool


def _device_of(variables):
    return next(iter(variables.values())).device


def batched_features(module, variables, images_nchw, batch_size=64):
    """GlobalPool(enc_conv4) features of (N, 3, 64, 64) images in [-1, 1]
    (numpy or a tensor), as an (N', 1024) float64 numpy array, N' the whole
    batches of `batch_size` in N: trailing images that do not fill one are
    dropped, as npe_tpu drops them. Runs on the device of `variables`."""
    n = (len(images_nchw) // batch_size) * batch_size
    if n == 0:
        raise ValueError(f"{len(images_nchw)} images make no batch of {batch_size}")
    x = torch.as_tensor(images_nchw[:n]).to(_device_of(variables), torch.float32)
    with torch.inference_mode():
        feats = [global_avg_pool(module.backbone(variables, x[i : i + batch_size], False, None)[-1])
                 for i in range(0, n, batch_size)]
        return torch.cat(feats).cpu().numpy().astype(np.float64)


def feature_stats(features):
    """(mean, covariance) of a (N, D) float64 feature matrix."""
    mu = features.mean(axis=0)
    cov = np.cov(features, rowvar=False)
    return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps=1e-6):
    """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2).

    The matrix square roots use symmetric eigendecompositions (the
    covariances are PSD), with a small diagonal jitter for rank-deficient
    sample covariances -- equivalent to the usual scipy.linalg.sqrtm
    formulation without the complex round trip."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64) + eps * np.eye(mu1.size)
    cov2 = np.asarray(cov2, np.float64) + eps * np.eye(mu2.size)

    def psd_sqrt(m):
        w, q = np.linalg.eigh(m)
        return (q * np.sqrt(np.clip(w, 0, None))) @ q.T

    s1 = psd_sqrt(cov1)
    middle = psd_sqrt(s1 @ cov2 @ s1)
    d2 = float(np.sum((mu1 - mu2) ** 2) + np.trace(cov1 + cov2 - 2.0 * middle))
    return max(d2, 0.0)


def model_samples(module, variables, num, batch_size=64, seed=0):
    """`num` decodes of N(0, 1) latents drawn from an explicit CPU
    torch.Generator seeded with `seed` (so the latents do not depend on the
    device), through the model's sample path: the pre-IAF decode for IAF
    models, as the trainer feeds Z (reference `train_IAN.py:479`).
    Returns an (num, 3, 64, 64) float32 tensor on the device of `variables`."""
    decode = module.decode_pre_iaf if getattr(module, "HAS_IAF", False) else module.decode
    gen = torch.Generator().manual_seed(seed)
    zdim = module.cfg["num_latents"]
    device = _device_of(variables)
    outs = []
    with torch.inference_mode():
        for _ in range(-(-num // batch_size)):
            z = torch.randn((batch_size, zdim), generator=gen).to(device)
            outs.append(decode(variables, z))
        return torch.cat(outs)[:num]


def encoder_fid(module, variables, real_images_nchw, num=None, batch_size=64, seed=0, feature_variables=None):
    """Frechet distance between encoder features of `real_images_nchw`
    (N, 3, 64, 64) in [-1, 1] and as many model samples.

    `feature_variables` fixes the encoder that defines the feature space;
    pass a reference checkpoint's variables so the metric is comparable
    across checkpoints of a run (with None, features come from the *current*
    `variables`, and a per-epoch curve conflates encoder drift with
    sample-quality change)."""
    num = num or len(real_images_nchw)
    batch_size = max(1, min(batch_size, num))  # small sets: one short batch
    fv = variables if feature_variables is None else feature_variables
    real = batched_features(module, fv, real_images_nchw[:num], batch_size)
    gen = batched_features(module, fv, model_samples(module, variables, num, batch_size, seed), batch_size)
    return frechet_distance(*feature_stats(real), *feature_stats(gen))


def main(argv=None):
    import argparse
    import json

    from npe_tpu_torch.data import data_loader, get_dataset
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.utils import checkpoints
    from npe_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--weights", default=None)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--num", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default="cuda", help="'cuda' (the default; raises without one) or 'cpu'")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    module = get_config(a.config)
    variables = module.init(torch.Generator().manual_seed(0), device)
    checkpoints.load_weights(a.weights or f"{module.cfg['model']}.npz", variables)
    ds = get_dataset(a.dataset, num_examples=a.num)
    cfg = dict(module.cfg, batch_size=a.batch_size, batches_per_chunk=max(1, -(-a.num // a.batch_size)))
    real = next(iter(data_loader(cfg, ds, offset=0)))
    fid = encoder_fid(module, variables, real, num=min(a.num, len(real)), batch_size=a.batch_size)
    print(json.dumps({"metric": "encoder_fid", "value": round(fid, 4), "num": a.num}))


if __name__ == "__main__":
    main()
