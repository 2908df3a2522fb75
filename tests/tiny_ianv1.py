"""Tiny IANv1-shaped test profile (user config module, loaded by path through
`npe_tpu.models.get_config`).

Same layer NAMES and code paths as `npe_tpu/models/ian_v1.py` (reference
`IANv1.py`) at 1/8 width with 16 latents: the shared encoder tower, two
MADE(16) nets and the IAF, the linear decoder FC, four deconvs down to 8
channels at 64x64, and the RGB-Beta head at its full 64x64 (so the
space-to-depth factor 4 and the 9x9 composed kernels hold). Only `decode`
differs from the model's, which hardcodes the 1024-channel reshape."""

from npe_tpu.models import common, ian_v1
from npe_tpu.models.common import VarBuilder, bn, unflatten_nchw
from npe_tpu.ops.activations import relu
from npe_tpu.ops.conv import deconv2d_phased as deconv2d
from npe_tpu.ops.linear import dense
from npe_tpu.ops.made import iaf_transform, made_apply, made_init
from npe_tpu.ops.sampling import gaussian_sample

cfg = dict(ian_v1.cfg, model="tiny_ianv1", batch_size=8, num_latents=16)

NUM_LATENTS = cfg["num_latents"]
N_DISCRIM_CLASSES = 1
HAS_IAF = True
MADE_HIDDEN = [NUM_LATENTS]
WIDTHS = (16, 32, 64, 128)
FC = 64
DEC_WIDTHS = (128, 64, 32, 16, 8)


def init(key):
    vb = VarBuilder(key)
    common.init_encoder(vb, NUM_LATENTS, widths=WIDTHS, fc=FC)
    for net in ("l_IAF_mu", "l_IAF_ls"):
        vb.v.update(made_init(vb.key(), net, NUM_LATENTS, MADE_HIDDEN, n_shuffles=cfg["n_shuffles"]))
    vb.dense("l_dec_fc2", NUM_LATENTS, DEC_WIDTHS[0] * 16, bias=True)
    for i in range(1, 5):
        vb.deconv(f"dec_conv{i}", DEC_WIDTHS[i - 1], DEC_WIDTHS[i], bias=False)
        vb.bn(f"bnorm_dc{i}", DEC_WIDTHS[i])
    for name, cin in (("R", 8), ("G_a", 8), ("G_b", 2), ("B_a", 8), ("B_b", 4)):
        vb.mdcl(name, cin, 2, [2, 3, 4])
    common.init_discrim(vb, N_DISCRIM_CLASSES, w_std=0.01, feat=WIDTHS[3], n_kernels=32)
    return vb.v


backbone = common.apply_backbone
discrim_logits = common.apply_discrim_head
encode_stats = ian_v1.encode_stats
rgb_beta_head = ian_v1.rgb_beta_head


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


def decode(v, z, train=False, upd=None):
    y = dense(z, v["l_dec_fc2.W"], v["l_dec_fc2.b"])
    h = unflatten_nchw(y, DEC_WIDTHS[0], 4, 4)
    for i in range(1, 5):
        h = relu(bn(v, upd, f"bnorm_dc{i}", deconv2d(h, v[f"dec_conv{i}.W"]), train))
    return rgb_beta_head(v, h)


def decode_pre_iaf(v, z, train=False, upd=None):
    z2, _, _ = iaf(v, z)
    return decode(v, z2, train, upd)


def sample_latent(mu, ls, rng):
    return gaussian_sample(mu, ls, rng)
