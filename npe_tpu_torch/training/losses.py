"""IAN training losses and parameter partitions (npe_tpu `training/losses.py`,
reference `train_IAN.py:47-276`).

Parameter partitions, as the reference's Lasagne graph walks give them
(`train_IAN.py:184-194`):

  * 'discrim' = everything upstream of l_discrim: the conv tower, the
    minibatch layer and the output dense. Trained by the discriminator loss
    only.
  * 'latent'  = enc_fc1 and the mu / logsigma heads with their batch norms:
    the reference's `Z_params`, trained on EVERY step (the `Z_gen_updates`
    dict is merged into both players' updates, `train_IAN.py:274-276`).
  * 'gen'     = the decoder.
  * 'frozen'  = the MADE / IAF nets. The reference places them in no update
    dict (IAN.py:1 is titled "IAN with RANDOMIZED IAF"): the flow keeps its
    orthogonal init.
  * 'state'   = what is not trainable: BN running statistics and MADE masks.

Loss definitions (`train_IAN.py:169-250`): pixel L1 (x2), KL to N(0,1),
ternary or binary adversarial CE, introspective feature-matching MSE, and the
orthogonal regularizer `ortho_res` (`train_IAN.py:158-165`).
"""

import math

import torch
import torch.nn.functional as F

from npe_tpu_torch.models.common import is_trainable
from npe_tpu_torch.utils.checkpoints import is_deconv

LATENT_HEAD_PREFIXES = (
    "enc_fc1.",
    "bnorm_enc_fc1.",
    "enc_mu.",
    "mu_bnorm.",
    "enc_logsigma.",
    "ls_bnorm.",
)
DISCRIM_PREFIXES = (
    "enc_conv",
    "bnorm2.",
    "bnorm3.",
    "bnorm4.",
    "minibatch_discrim.",
    "discrimi.",
)
FROZEN_PREFIXES = ("l_IAF_",)
PARTITIONS = ("discrim", "latent", "gen", "frozen", "state")


def partition_of(name):
    if not is_trainable(name):
        return "state"
    if name.startswith(FROZEN_PREFIXES):
        return "frozen"
    if name.startswith(LATENT_HEAD_PREFIXES):
        return "latent"
    if name.startswith(DISCRIM_PREFIXES):
        return "discrim"
    return "gen"


def partition_variables(variables):
    parts = {p: {} for p in PARTITIONS}
    for k, v in variables.items():
        parts[partition_of(k)][k] = v
    return parts


def merge_partitions(parts):
    out = {}
    for d in parts.values():
        out.update(d)
    return out


# --- individual losses -------------------------------------------------------


def pixel_l1(x_hat, x):
    """`train_IAN.py:169`: mean(2*|X_hat - X + 1e-8|)."""
    return torch.mean(2.0 * torch.abs(x_hat - x + 1e-8))


def pixel_mse(x_hat, x):
    return torch.mean((x_hat - x) ** 2)


def gaussian_nll_pixel(x_hat, x, log_sigma):
    """Gaussian NLL pixel loss with a learned per-pixel log_sigma map, the
    legacy training script's variant (reference `train_IAN_simple.py:300-310`):
    0.5*mean(log(2*pi) + 2*log_sigma + (x_hat - x)^2 / exp(2*log_sigma))."""
    return 0.5 * torch.mean(
        math.log(2 * math.pi) + 2 * log_sigma + (x_hat - x) ** 2 / torch.exp(2 * log_sigma)
    )


def kl_to_standard_normal(mu, ls):
    """`train_IAN.py:172`: -0.5*mean(1 + 2*ls - mu^2 - exp(2*ls))."""
    return -0.5 * torch.mean(1 + 2 * ls - mu**2 - torch.exp(2 * ls))


def feature_matching(feats_x, feats_xhat):
    """Introspective loss (`train_IAN.py:244`): mean over layers of MSE."""
    return torch.stack([torch.mean((a - b) ** 2) for a, b in zip(feats_x, feats_xhat)]).mean()


def softmax_ce(logits, class_idx):
    """Categorical CE against a constant one-hot class."""
    return -torch.mean(F.log_softmax(logits, dim=-1)[:, class_idx])


def sigmoid_bce(logits, target):
    """Binary CE against a constant 0/1 target, stable form:
    max(x, 0) - x*t + log1p(exp(-|x|))."""
    x = logits[:, 0]
    return torch.mean(torch.clamp(x, min=0) - x * target + torch.log1p(torch.exp(-torch.abs(x))))


def ortho_res(w, deconv=False):
    """`train_IAN.py:158-165` on a 4-D weight. On npe_tpu's (kh, kw, cin,
    cout) kernels, conv and deconv alike: y[o,h,h'] = sum_{w,i} W[h,w,i,o]
    W[h',w,i,o]; penalty = sum|y - I|. The port's conv kernels are
    (cout, cin, kh, kw) and its deconv kernels (cin, cout, kh, kw), so the
    same contraction is spelled per kind."""
    y = torch.einsum("iohw,iokw->ohk" if deconv else "oihw,oikw->ohk", w, w)
    eye = torch.eye(w.shape[2], dtype=w.dtype, device=w.device)[None]
    return torch.sum(torch.abs(y - eye))


def ortho_penalty(params):
    """Applied to every 4-D param named *W (`train_IAN.py:161`): conv and
    deconv kernels and the MDCL filters (conv layout)."""
    s = 0.0
    for k, v in params.items():
        if k.endswith("W") and v.ndim == 4:
            s = s + ortho_res(v, deconv=is_deconv(k))
    return s


def l2_penalty(params):
    """Lasagne l2 over 'regularizable' params = weight matrices, not
    biases/gains (`train_IAN.py:211-213`)."""
    s = 0.0
    for k, v in params.items():
        if k.endswith("W") or k.endswith(".theta"):
            s = s + torch.sum(v**2)
    return s


# --- adversarial objectives ---------------------------------------------------

# Ternary class indices (`train_IAN.py:482-484`): p1=real, p2=recon, p3=sample.
REAL, RECON, SAMPLE = 0, 1, 2


def _frac(cond):
    return cond.to(torch.float32).mean()


def adversarial_losses(p_x, p_x_hat, p_x_gen, n_classes):
    """Returns dict with discrim_d/discrim_g/gen_recon/gen_sample losses and
    discriminator accuracy, for ternary-softmax (`train_IAN.py:228-250`) or
    binary-sigmoid (legacy `train_IAN_simple.py:395-407`) discriminators."""
    if n_classes == 3:
        d_g = softmax_ce(p_x_hat, RECON) + softmax_ce(p_x_gen, SAMPLE)
        d_d = softmax_ce(p_x, REAL)
        g_recon = softmax_ce(p_x_hat, REAL)
        g_sample = softmax_ce(p_x_gen, REAL)
        acc = (
            _frac(p_x.argmax(-1) == REAL)
            + _frac(p_x_hat.argmax(-1) == RECON)
            + _frac(p_x_gen.argmax(-1) == SAMPLE)
        ) / 3.0
    else:
        d_g = sigmoid_bce(p_x_hat, 0.0) + sigmoid_bce(p_x_gen, 0.0)
        d_d = sigmoid_bce(p_x, 1.0)
        g_recon = sigmoid_bce(p_x_hat, 1.0)
        g_sample = sigmoid_bce(p_x_gen, 1.0)
        acc = (_frac(p_x[:, 0] > 0) + _frac(p_x_hat[:, 0] < 0) + _frac(p_x_gen[:, 0] < 0)) / 3.0
    return {
        "discrim_g_loss": d_g,
        "discrim_d_loss": d_d,
        "gen_recon_loss": g_recon,
        "gen_sample_loss": g_sample,
        "discrim_acc": acc,
    }
