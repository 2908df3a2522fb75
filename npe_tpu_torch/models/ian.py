"""IAN: the full Introspective Adversarial Network (npe_tpu `models/ian.py`,
reference `IAN.py`).

    encoder: the shared tower (`models/common.py`), relu on the FC
    latent:  z = IAF(mu), two MADE(100) nets, as IANv1's (`IAN.py:126-128`)
    decoder: FC 512*16 with LeakyReLU -> reshape (512,4,4) -> deconv 512,
             MDBLOCK(512, scales 0/2), deconv 256, MDBLOCK(256, 0/2/3),
             deconv 128, MDBLOCK(128, 0/2/3), deconv 128 + BN + LeakyReLU
             (`IAN.py:129-181`; the first three deconvs have a bias and no
             BN) -> the autoregressive RGB-Beta head (`common.rgb_beta_head`)

A ternary softmax discriminator, real / reconstruction / sample
(`IAN.py:210-216`). Images are NCHW float32 in [-1, 1]. Widths are read from
the weights, so the narrow test profile runs this same code.
"""

from npe_tpu_torch.models import common
from npe_tpu_torch.models.common import LRELU, VarBuilder, bn, mdblock, unflatten_nchw
from npe_tpu_torch.models.ian_v1 import (  # noqa: F401  (the same functions, re-exported)
    HEAD_SCALES, backbone, discrim_logits, encode, encode_pre_iaf, encode_stats, iaf, rgb_beta_head,
    sample_latent,
)
from npe_tpu_torch.ops.conv import deconv2d
from npe_tpu_torch.ops.linear import dense
from npe_tpu_torch.ops.made import made_init
from npe_tpu_torch.utils.device import resolve_device

lr_schedule = {0: 0.0002, 25: 0.0001, 50: 0.00005, 75: 0.00001}
# Hyperparameters per reference `IAN.py:38-62`.
cfg = {
    "model": "IAN",
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
    "max_epochs": 80,
    "checkpoint_every_nth": 1,
    "num_latents": 100,
    "recon_weight": 3.0,
    "feature_weight": 1.0,
    "dg_weight": 1.0,
    "dd_weight": 1.0,
    "agr_weight": 1.0,
    "ags_weight": 1.0,
    "n_shuffles": 1,
    "ortho": 1e-3,
}

NUM_LATENTS = cfg["num_latents"]
N_DISCRIM_CLASSES = 3  # ternary softmax discriminator (`IAN.py:210-216`)
HAS_IAF = True
MADE_HIDDEN = [NUM_LATENTS]
# The three MDBLOCKs: (name, scales), each after the deconv of the same number.
MDBLOCKS = (("dec_conv2a", (0, 2)), ("dec_conv3a", (0, 2, 3)), ("dec_conv4a", (0, 2, 3)))


def init_iaf_and_decoder(vb, num_latents, made_hidden, widths, n_shuffles):
    """Everything after the encoder, in npe_tpu's draw order: the two MADE
    nets, the decoder FC, three [deconv with bias, MDBLOCK] pairs (`widths`:
    the 4x4 map's channels, then each deconv's output), the last deconv to
    the same width with its BN, and the head's five MDCLs."""
    for net in ("l_IAF_mu", "l_IAF_ls"):
        vb.v.update(
            made_init(vb.gen, net, num_latents, made_hidden, vb.device, n_shuffles=n_shuffles)
        )
    vb.dense("l_dec_fc2", num_latents, widths[0] * 16, bias=True)
    for i, (name, scales) in enumerate(MDBLOCKS, start=1):
        vb.deconv(f"dec_conv{i}", widths[i - 1], widths[i], bias=True)
        vb.mdcl(name, widths[i], widths[i], list(scales))
        vb.mdcl(f"{name}2", widths[i], widths[i], list(scales))
        for k in range(3):
            vb.bn(f"{name}bnorm{k}", widths[i])
    vb.deconv("dec_conv4", widths[3], widths[3], bias=False)
    vb.bn("bnorm_dc4", widths[3])
    for name, cin in (("R", widths[3]), ("G_a", widths[3]), ("G_b", 2), ("B_a", widths[3]), ("B_b", 4)):
        vb.mdcl(name, cin, 2, list(HEAD_SCALES))


def init(gen, device="cuda"):
    """Random variables drawn from torch.Generator `gen`, on `device`."""
    vb = VarBuilder(gen, resolve_device(device))
    common.init_encoder(vb, NUM_LATENTS)
    init_iaf_and_decoder(vb, NUM_LATENTS, MADE_HIDDEN, (512, 512, 256, 128), cfg["n_shuffles"])
    common.init_discrim(vb, N_DISCRIM_CLASSES, w_std=0.02)
    return vb.v


def decode(v, z, train=False, upd=None, head_mode=None, mdblock_mode=None):
    """Decoder-input (post-IAF) latent (N, zdim) -> image (N, 3, 64, 64).
    `head_mode` names the RGB-Beta head's form (`common.HEAD_MODES`) and
    `mdblock_mode` the three MDBLOCKs' (`common.MDBLOCK_MODES`); None takes
    `common.HEAD_MODE` / `common.MDBLOCK_MODE`."""
    y = LRELU(dense(z, v["l_dec_fc2.W"], v["l_dec_fc2.b"]))
    h = unflatten_nchw(y, v["l_dec_fc2.W"].shape[1] // 16, 4, 4)
    for i, (name, scales) in enumerate(MDBLOCKS, start=1):
        h = deconv2d(h, v[f"dec_conv{i}.W"], v[f"dec_conv{i}.b"])
        h = mdblock(v, upd, name, h, scales, LRELU, train, mode=mdblock_mode)
    h = LRELU(bn(v, upd, "bnorm_dc4", deconv2d(h, v["dec_conv4.W"]), train))
    return rgb_beta_head(v, h, mode=head_mode)


def decode_pre_iaf(v, z, train=False, upd=None, head_mode=None, mdblock_mode=None):
    z2, _, _ = iaf(v, z)
    return decode(v, z2, train, upd, head_mode, mdblock_mode)
