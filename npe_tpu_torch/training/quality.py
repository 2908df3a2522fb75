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

from npe_tpu_torch.training.programs import EvalPrograms, sample_program


def batched_features(module, variables, images_nchw, batch_size=64, programs=None):
    """GlobalPool(enc_conv4) features of (N, 3, 64, 64) images in [-1, 1]
    (numpy or a tensor), as an (N', 1024) float64 numpy array, N' the whole
    batches of `batch_size` in N: trailing images that do not fill one are
    dropped, as npe_tpu drops them. Each batch is one run of the `features`
    program of `programs`, an `EvalPrograms` that holds `variables` (None
    makes one on their device for the call)."""
    n = (len(images_nchw) // batch_size) * batch_size
    if n == 0:
        raise ValueError(f"{len(images_nchw)} images make no batch of {batch_size}")
    if programs is None:
        programs = EvalPrograms.of(module, variables)
    x = torch.as_tensor(images_nchw[:n]).to(programs.device, torch.float32)
    feats = [programs("features", x[i : i + batch_size]) for i in range(0, n, batch_size)]
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


def model_samples(module, variables, num, batch_size=64, seed=0, programs=None):
    """`num` decodes of N(0, 1) latents drawn from an explicit CPU
    torch.Generator seeded with `seed` (so the latents do not depend on the
    device), through the model's sample path (`programs.sample_program`: the
    pre-IAF decode for IAF models, as the trainer feeds Z, reference
    `train_IAN.py:479`), each batch one run of that program of `programs`,
    an `EvalPrograms` that holds `variables` (None makes one on their device
    for the call). Returns an (num, 3, 64, 64) float32 tensor on the device
    of `variables`."""
    if programs is None:
        programs = EvalPrograms.of(module, variables)
    gen = torch.Generator().manual_seed(seed)
    zdim = module.cfg["num_latents"]
    name = sample_program(module)
    outs = [programs(name, torch.randn((batch_size, zdim), generator=gen)) for _ in range(-(-num // batch_size))]
    return torch.cat(outs)[:num]


def encoder_fid(module, variables, real_images_nchw, num=None, batch_size=64, seed=0, feature_variables=None,
                programs=None, feature_programs=None):
    """Frechet distance between encoder features of `real_images_nchw`
    (N, 3, 64, 64) in [-1, 1] and as many model samples.

    `feature_variables` fixes the encoder that defines the feature space;
    pass a reference checkpoint's variables so the metric is comparable
    across checkpoints of a run (with None, features come from the *current*
    `variables`, and a per-epoch curve conflates encoder drift with
    sample-quality change). The samples run on `programs`, an `EvalPrograms`
    that holds `variables`, the features on `feature_programs`, one that
    holds the feature space's weights (the trainer keeps both across
    checkpoints); None makes each for the call."""
    num = num or len(real_images_nchw)
    batch_size = max(1, min(batch_size, num))  # small sets: one short batch
    if programs is None:
        programs = EvalPrograms.of(module, variables)
    if feature_programs is None:
        feature_programs = programs if feature_variables is None else EvalPrograms.of(module, feature_variables)
    real = batched_features(module, None, real_images_nchw[:num], batch_size, feature_programs)
    samples = model_samples(module, None, num, batch_size, seed, programs)
    gen = batched_features(module, None, samples, batch_size, feature_programs)
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
