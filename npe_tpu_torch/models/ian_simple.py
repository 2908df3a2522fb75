"""IAN_simple: the NPE's default model (npe_tpu `models/ian_simple.py`,
reference `IAN_simple.py`).

    encoder: 4x [5x5 stride-2 conv 128/256/512/1024, lrelu(0.2), BN from
             conv2 on] -> FC 1000 (BN, elu) -> batchnormed mu / logsigma (100)
    decoder: FC 1024*16 (BN, relu) -> reshape (1024,4,4) -> 3x [5x5 stride-2
             deconv 512/256/128, BN, relu] -> 5x5 stride-2 deconv 3, tanh

Images are NCHW float32 in [-1, 1]. Widths are read from the weights, so the
narrow test profile runs this same code.
"""

import torch

from npe_tpu_torch.models import common
from npe_tpu_torch.models.common import VarBuilder, bn, unflatten_nchw
from npe_tpu_torch.ops.activations import relu
from npe_tpu_torch.ops.conv import deconv2d
from npe_tpu_torch.ops.linear import dense
from npe_tpu_torch.ops.sampling import gaussian_sample
from npe_tpu_torch.utils.device import resolve_device

# Hyperparameters per reference `IAN_simple.py:32-51`.
cfg = {
    "model": "IAN_simple",
    "batch_size": 128,
    "learning_rate": {0: 0.0002},
    "optimizer": "Adam",
    "beta1": 0.5,
    "update_ratio": 1,
    "decay_rate": 0,
    "reg": 1e-5,
    "momentum": 0.9,
    "shuffle": True,
    "dims": (64, 64),
    "n_channels": 3,
    "n_classes": 10,
    "batches_per_chunk": 64,
    "max_epochs": 250,
    "checkpoint_every_nth": 1,
    "num_latents": 100,
    "recon_weight": 3.0,
    "feature_weight": 1.0,
    "dg_weight": 1.0,
    "dd_weight": 1.0,
    "agr_weight": 1.0,
    "ags_weight": 1.0,
}

NUM_LATENTS = cfg["num_latents"]
N_DISCRIM_CLASSES = 1  # binary sigmoid discriminator (`IAN_simple.py:226-231`)
HAS_IAF = False


def init(gen, device="cuda"):
    """Random variables drawn from torch.Generator `gen`, on `device`."""
    vb = VarBuilder(gen, resolve_device(device))
    common.init_encoder(vb, NUM_LATENTS)
    vb.dense("l_dec_fc2", NUM_LATENTS, 1024 * 16, bias=False)
    vb.bn("bnorm_dec_fc2", 1024 * 16)
    vb.deconv("dec_conv1", 1024, 512, bias=False)
    vb.bn("bnorm_dc1", 512)
    vb.deconv("dec_conv2", 512, 256, bias=False)
    vb.bn("bnorm_dc2", 256)
    vb.deconv("dec_conv3", 256, 128, bias=False)
    vb.bn("bnorm_dc3", 128)
    vb.deconv("dec_out", 128, 3, bias=False)  # b=None in reference
    common.init_discrim(vb, N_DISCRIM_CLASSES, w_std=0.01)
    return vb.v


backbone = common.apply_backbone
discrim_logits = common.apply_discrim_head


def encode_stats(v, x, train=False, upd=None):
    """x -> (mu, logsigma, introspection features)."""
    feats = common.apply_backbone(v, x, train, upd)
    mu, ls = common.apply_latent_heads(v, feats[-1], train, upd)
    return mu, ls, feats


def encode(v, x):
    """Deterministic encode to the decoder-input latent: z = mu."""
    mu, _, _ = encode_stats(v, x)
    return mu


# For the non-IAF model the pre-IAF and decoder-input latents coincide.
encode_pre_iaf = encode


def iaf(v, z):
    """Identity flow (no IAF in this config); returns (z, mu=0, ls=0)."""
    zero = torch.zeros_like(z)
    return z, zero, zero


def decode(v, z, train=False, upd=None):
    """Decoder-input latent (N, zdim) -> image (N, 3, 64, 64) in [-1, 1]."""
    y = relu(bn(v, upd, "bnorm_dec_fc2", dense(z, v["l_dec_fc2.W"]), train))
    h = unflatten_nchw(y, v["l_dec_fc2.W"].shape[1] // 16, 4, 4)
    h = relu(bn(v, upd, "bnorm_dc1", deconv2d(h, v["dec_conv1.W"]), train))
    h = relu(bn(v, upd, "bnorm_dc2", deconv2d(h, v["dec_conv2.W"]), train))
    h = relu(bn(v, upd, "bnorm_dc3", deconv2d(h, v["dec_conv3.W"]), train))
    return torch.tanh(deconv2d(h, v["dec_out.W"]))


decode_pre_iaf = decode


def sample_latent(mu, ls, noise):
    return gaussian_sample(mu, ls, noise)
