"""Shared model-building blocks for the IAN family (npe_tpu `models/common.py`).

The encoder tower: four stride-2 5x5 convs 128/256/512/1024 with
LeakyReLU(0.2), batch norm from conv2 on, a 1000-unit FC, and 100-dim
batchnormed mu / logsigma heads (reference `IAN_simple.py:73-126`).
Parameter names are the reference's Lasagne names, in one flat dict that also
holds the non-trainable BN state (`.mean`, `.inv_std`). Every apply function
reads widths from the weights, so narrow test profiles run the same code.
Activations are NCHW.
"""

import torch

from npe_tpu_torch.ops.activations import elu, lrelu
from npe_tpu_torch.ops.conv import enc_conv2d
from npe_tpu_torch.ops.initializers import normal
from npe_tpu_torch.ops.linear import dense
from npe_tpu_torch.ops.norm import batch_norm_apply


class VarBuilder:
    """Init-time helper: owns a torch.Generator and the flat variables dict.
    Kernels are drawn in the port's layouts: conv (cout, cin, kh, kw),
    deconv (cin, cout, kh, kw)."""

    def __init__(self, gen, device):
        self.gen = gen
        self.device = device
        self.v = {}

    def _zeros(self, *shape):
        return torch.zeros(shape, device=self.device)

    def _full(self, shape, val):
        return torch.full(shape, val, dtype=torch.float32, device=self.device)

    def conv(self, name, cin, cout, ksize=5, std=0.02, bias=True):
        self.v[f"{name}.W"] = normal(std)(self.gen, (cout, cin, ksize, ksize), self.device)
        if bias:
            self.v[f"{name}.b"] = self._zeros(cout)

    def deconv(self, name, cin, cout, ksize=5, std=0.02, bias=True):
        self.v[f"{name}.W"] = normal(std)(self.gen, (cin, cout, ksize, ksize), self.device)
        if bias:
            self.v[f"{name}.b"] = self._zeros(cout)

    def dense(self, name, nin, nout, std=0.02, bias=True):
        self.v[f"{name}.W"] = normal(std)(self.gen, (nin, nout), self.device)
        if bias:
            self.v[f"{name}.b"] = self._zeros(nout)

    def bn(self, name, c):
        self.v[f"{name}.beta"] = self._zeros(c)
        self.v[f"{name}.gamma"] = self._full((c,), 1.0)
        self.v[f"{name}.mean"] = self._zeros(c)
        self.v[f"{name}.inv_std"] = self._full((c,), 1.0)

    def minibatch(self, name, nin, num_kernels=500, dim_per_kernel=5):
        self.v[f"{name}.theta"] = normal(0.05)(
            self.gen, (nin, num_kernels, dim_per_kernel), self.device
        )
        self.v[f"{name}.log_weight_scale"] = self._zeros(num_kernels, dim_per_kernel)
        self.v[f"{name}.b"] = self._full((num_kernels,), -1.0)


def bn(v, upd, name, x, train):
    y, (m, s) = batch_norm_apply(
        x, v[f"{name}.beta"], v[f"{name}.gamma"], v[f"{name}.mean"], v[f"{name}.inv_std"], train
    )
    if train and upd is not None:
        upd[f"{name}.mean"] = m
        upd[f"{name}.inv_std"] = s
    return y


def init_encoder(vb, num_latents, in_channels=3, widths=(128, 256, 512, 1024), fc=1000):
    """Encoder + latent-head parameters (reference `IAN_simple.py:73-126`)."""
    vb.conv("enc_conv1", in_channels, widths[0], bias=True)
    vb.conv("enc_conv2", widths[0], widths[1], bias=False)
    vb.bn("bnorm2", widths[1])
    vb.conv("enc_conv3", widths[1], widths[2], bias=False)
    vb.bn("bnorm3", widths[2])
    vb.conv("enc_conv4", widths[2], widths[3], bias=False)
    vb.bn("bnorm4", widths[3])
    vb.dense("enc_fc1", widths[3] * 4 * 4, fc, bias=False)
    vb.bn("bnorm_enc_fc1", fc)
    vb.dense("enc_mu", fc, num_latents, bias=False)
    vb.bn("mu_bnorm", num_latents)
    vb.dense("enc_logsigma", fc, num_latents, bias=False)
    vb.bn("ls_bnorm", num_latents)


def init_discrim(vb, n_units, w_std, feat=1024, n_kernels=500, dim_per_kernel=5):
    """Discriminator-head parameters. The port does not train yet, but a
    file it writes must hold every name npe_tpu expects."""
    vb.minibatch("minibatch_discrim", feat, n_kernels, dim_per_kernel)
    vb.dense("discrimi", feat + n_kernels, n_units, std=w_std, bias=False)


LRELU = lrelu(0.2)


def apply_backbone(v, x, train, upd):
    """Encoder conv tower -> the four introspection feature maps.
    x: (N, 3, 64, 64) NCHW in [-1, 1]."""
    c1 = LRELU(enc_conv2d(x, v["enc_conv1.W"], b=v["enc_conv1.b"]))
    c2 = LRELU(bn(v, upd, "bnorm2", enc_conv2d(c1, v["enc_conv2.W"]), train))
    c3 = LRELU(bn(v, upd, "bnorm3", enc_conv2d(c2, v["enc_conv3.W"]), train))
    c4 = LRELU(bn(v, upd, "bnorm4", enc_conv2d(c3, v["enc_conv4.W"]), train))
    return c1, c2, c3, c4


def apply_latent_heads(v, c4, train, upd, act=elu):
    """conv4 -> fc1 -> batchnormed (mu, logsigma); elu for IAN_simple."""
    f = act(bn(v, upd, "bnorm_enc_fc1", dense(c4, v["enc_fc1.W"]), train))
    mu = bn(v, upd, "mu_bnorm", dense(f, v["enc_mu.W"]), train)
    ls = bn(v, upd, "ls_bnorm", dense(f, v["enc_logsigma.W"]), train)
    return mu, ls


def unflatten_nchw(y, c, h, w):
    """Lasagne ReshapeLayer([0], C, H, W): a C-order reshape, already NCHW."""
    return y.reshape(y.shape[0], c, h, w)
