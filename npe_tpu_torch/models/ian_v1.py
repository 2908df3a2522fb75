"""IANv1: the v1 full IAN (npe_tpu `models/ian_v1.py`, reference `IANv1.py`).

    encoder: the shared tower (`models/common.py`), relu on the FC
    latent:  z = IAF(mu): two MADE(100) nets give (mu_iaf, logsigma_iaf),
             z = (mu - mu_iaf) / exp(logsigma_iaf)
    decoder: linear FC 1024*16 -> reshape (1024,4,4) -> 4x [5x5 stride-2
             deconv 512/256/128/64, BN, relu] -> the autoregressive RGB-Beta
             head (five MDCLs, scales 2/3/4; `common.rgb_beta_head`)

A binary sigmoid discriminator as IAN_simple's (`IANv1.py:122-209`). Images
are NCHW float32 in [-1, 1]. Widths are read from the weights, so the narrow
test profile runs this same code.
"""

from npe_tpu_torch.models import common
from npe_tpu_torch.models.common import VarBuilder, bn, unflatten_nchw
from npe_tpu_torch.ops.activations import relu
from npe_tpu_torch.ops.conv import deconv2d
from npe_tpu_torch.ops.linear import dense
from npe_tpu_torch.ops.made import iaf_transform, made_apply, made_init
from npe_tpu_torch.ops.sampling import gaussian_sample
from npe_tpu_torch.utils.device import resolve_device

lr_schedule = {0: 0.0002, 25: 0.0001, 50: 0.00005, 75: 0.00001}
# Hyperparameters per reference `IANv1.py:38-61` (lr drops at 25/50/75,
# same schedule as IAN's, `IANv1.py:38`).
cfg = {
    "model": "IANv1",
    "batch_size": 16,
    "learning_rate": lr_schedule,
    "optimizer": "Adam",
    "beta1": 0.5,
    "update_ratio": 1,
    "decay_rate": 0,
    "reg": 1e-5,
    "momentum": 0.9,
    "shuffle": True,
    "dims": (64, 64),
    "n_channels": 3,
    "batches_per_chunk": 64,
    "max_epochs": 150,
    "checkpoint_every_nth": 1,
    "num_latents": 100,
    "recon_weight": 3.0,
    "feature_weight": 1.0,
    "dg_weight": 1.0,
    "dd_weight": 1.0,
    "agr_weight": 1.0,
    "ags_weight": 1.0,
    "n_shuffles": 1,
}

NUM_LATENTS = cfg["num_latents"]
N_DISCRIM_CLASSES = 1  # binary sigmoid (`IANv1.py:203-209`)
HAS_IAF = True
MADE_HIDDEN = [NUM_LATENTS]
HEAD_SCALES = (2, 3, 4)


def init_iaf_and_decoder(vb, num_latents, made_hidden, widths, n_shuffles):
    """Everything after the encoder: the two MADE nets, the decoder FC and
    deconvs (`widths`: the 4x4 map's channels, then each deconv's output),
    and the head's five MDCLs."""
    for net in ("l_IAF_mu", "l_IAF_ls"):
        vb.v.update(
            made_init(vb.gen, net, num_latents, made_hidden, vb.device, n_shuffles=n_shuffles)
        )
    vb.dense("l_dec_fc2", num_latents, widths[0] * 16, bias=True)
    for i in range(1, len(widths)):
        vb.deconv(f"dec_conv{i}", widths[i - 1], widths[i], bias=False)
        vb.bn(f"bnorm_dc{i}", widths[i])
    for name, cin in (("R", widths[-1]), ("G_a", widths[-1]), ("G_b", 2), ("B_a", widths[-1]), ("B_b", 4)):
        vb.mdcl(name, cin, 2, list(HEAD_SCALES))


def init(gen, device="cuda"):
    """Random variables drawn from torch.Generator `gen`, on `device`."""
    vb = VarBuilder(gen, resolve_device(device))
    common.init_encoder(vb, NUM_LATENTS)
    init_iaf_and_decoder(vb, NUM_LATENTS, MADE_HIDDEN, (1024, 512, 256, 128, 64), cfg["n_shuffles"])
    common.init_discrim(vb, N_DISCRIM_CLASSES, w_std=0.01)
    return vb.v


backbone = common.apply_backbone
discrim_logits = common.apply_discrim_head


def encode_stats(v, x, train=False, upd=None):
    feats = common.apply_backbone(v, x, train, upd)
    # enc_fc1 uses relu in this config (`IAN.py:121` / `IANv1.py:114`),
    # unlike IAN_simple's elu.
    mu, ls = common.apply_latent_heads(v, feats[-1], train, upd, act=relu)
    return mu, ls, feats


def iaf(v, z):
    mu = made_apply(v, "l_IAF_mu", z, n_hidden=len(MADE_HIDDEN))
    ls = made_apply(v, "l_IAF_ls", z, n_hidden=len(MADE_HIDDEN))
    return iaf_transform(z, mu, ls), mu, ls


def encode_pre_iaf(v, x):
    mu, _, _ = encode_stats(v, x)
    return mu


def encode(v, x):
    z, _, _ = iaf(v, encode_pre_iaf(v, x))
    return z


def rgb_beta_head(v, h, mode=None):
    """Autoregressive RGB-Beta output (`IAN.py:183-207`); the shared
    implementation and its forms are in models/common.py."""
    return common.rgb_beta_head(v, h, scales=HEAD_SCALES, mode=mode)


def decode(v, z, train=False, upd=None, head_mode=None):
    """Decoder-input (post-IAF) latent (N, zdim) -> image (N, 3, 64, 64).
    `head_mode` names the RGB-Beta head's form (`common.HEAD_MODES`); None
    takes `common.HEAD_MODE`."""
    y = dense(z, v["l_dec_fc2.W"], v["l_dec_fc2.b"])  # linear (`IANv1.py:128`)
    h = unflatten_nchw(y, v["l_dec_fc2.W"].shape[1] // 16, 4, 4)
    for i in (1, 2, 3, 4):
        h = relu(bn(v, upd, f"bnorm_dc{i}", deconv2d(h, v[f"dec_conv{i}.W"]), train))
    return rgb_beta_head(v, h, mode=head_mode)


def decode_pre_iaf(v, z, train=False, upd=None, head_mode=None):
    z2, _, _ = iaf(v, z)
    return decode(v, z2, train, upd, head_mode)


def sample_latent(mu, ls, noise):
    return gaussian_sample(mu, ls, noise)
