"""Shared model-building blocks for the IAN family (npe_tpu `models/common.py`):
the encoder tower, the MDCL helpers, the MDBLOCK and the autoregressive
RGB-Beta head.

The encoder tower: four stride-2 5x5 convs 128/256/512/1024 with
LeakyReLU(0.2), batch norm from conv2 on, a 1000-unit FC, and 100-dim
batchnormed mu / logsigma heads (reference `IAN_simple.py:73-126`).
Parameter names are the reference's Lasagne names, in one flat dict that also
holds the non-trainable BN state (`.mean`, `.inv_std`). Every apply function
reads widths from the weights, so narrow test profiles run the same code.
Activations are NCHW.
"""

import torch

from npe_tpu_torch.ops.activations import elu, lrelu, sigmoid
from npe_tpu_torch.ops.beta import beta_mean
from npe_tpu_torch.ops.conv import (
    conv2d, depth_to_space, enc_conv2d, global_avg_pool, pack_kernel_s2d, space_to_depth,
)
from npe_tpu_torch.ops.initializers import normal
from npe_tpu_torch.ops.kernels.mdblock import mdblock_fused, stack_mdcl_taps
from npe_tpu_torch.ops.kernels.rgb_beta_head import rgb_beta_head as rgb_beta_head_kernel
from npe_tpu_torch.ops.kernels.rgb_beta_tail import pack_head_taps, rgb_beta_tail
from npe_tpu_torch.ops.linear import dense
from npe_tpu_torch.ops.mdcl import compose_mdcl_kernel, mdcl_apply
from npe_tpu_torch.ops.minibatch import minibatch_discrimination
from npe_tpu_torch.ops.norm import batch_norm_apply
from npe_tpu_torch.parallel.collectives import current_data_axis

NON_TRAINABLE_SUFFIXES = (".mean", ".inv_std", ".weights_mask")


def is_trainable(name):
    return not name.endswith(NON_TRAINABLE_SUFFIXES)


def split_trainable(variables):
    params = {k: v for k, v in variables.items() if is_trainable(k)}
    state = {k: v for k, v in variables.items() if not is_trainable(k)}
    return params, state


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

    def mdcl(self, name, cin, cout, scales, std=0.02):
        # Reference `layers.py:207-258`: shared 3x3 W + per-branch coeffs
        # initialized to 1/(1+len(scales)).
        c0 = 1.0 / (1 + len(scales))
        self.v[f"{name}W"] = normal(std)(self.gen, (cout, cin, 3, 3), self.device)
        self.v[f"{name}_coeff_base"] = self._full((cout,), c0)
        for s in scales:
            self.v[f"{name}_coeff_{_coeff_suffix(s)}"] = self._full((cout,), c0)

    def minibatch(self, name, nin, num_kernels=500, dim_per_kernel=5):
        self.v[f"{name}.theta"] = normal(0.05)(
            self.gen, (nin, num_kernels, dim_per_kernel), self.device
        )
        self.v[f"{name}.log_weight_scale"] = self._zeros(num_kernels, dim_per_kernel)
        self.v[f"{name}.b"] = self._full((num_kernels,), -1.0)


def _coeff_suffix(scale):
    return "1x1" if scale == 0 else str(scale)


def bn(v, upd, name, x, train):
    """Batch norm of layer `name`; in training mode over the global batch of
    the data axis a training step has set (`parallel.collectives.data_axis`),
    else over x's rows."""
    y, (m, s) = batch_norm_apply(
        x, v[f"{name}.beta"], v[f"{name}.gamma"], v[f"{name}.mean"], v[f"{name}.inv_std"], train,
        axis=current_data_axis() if train else None,
    )
    if train and upd is not None:
        upd[f"{name}.mean"] = m
        upd[f"{name}.inv_std"] = s
    return y


def _composed_mdcl_kernel(v, name, scales):
    coeffs = {s: v[f"{name}_coeff_{_coeff_suffix(s)}"] for s in scales}
    return compose_mdcl_kernel(v[f"{name}W"], v[f"{name}_coeff_base"], coeffs, scales)


def mdcl(v, name, x, scales):
    coeffs = {s: v[f"{name}_coeff_{_coeff_suffix(s)}"] for s in scales}
    return mdcl_apply(x, v[f"{name}W"], v[f"{name}_coeff_base"], coeffs, scales)


def _bn_affine(v, name):
    """Inference batch norm as a per-channel float32 affine: (s, t) with
    BN(x) = s * x + t. As npe_tpu's (`models/common.py:_bn_affine`), gamma *
    inv_std is formed in the weights' dtype (bf16 under a bf16 cast) and then
    widened, so the fused MDBLOCK's affines are float32 in both forms."""
    s = (v[f"{name}.gamma"] * v[f"{name}.inv_std"]).float()
    return s, v[f"{name}.beta"].float() - v[f"{name}.mean"].float() * s


def _stacked_mdcl_taps(v, name, scales):
    coeffs = {s: v[f"{name}_coeff_{_coeff_suffix(s)}"] for s in scales}
    return stack_mdcl_taps(v[f"{name}W"], v[f"{name}_coeff_base"], coeffs, scales)


# The forms of the MDBLOCK, the same math (tests/test_torch_mdblock.py):
#   "plain"  the per-op form: bn, `mdcl`, bn, `mdcl`, bn of x + h, each MDCL
#            one library conv with the composed kernel;
#   "fused"  the hand-written `mdblock_fused` kernel on the inference path.
# MDBLOCK_MODE is the form taken when the caller names none: a constant, the
# same on every device, "plain" as npe_tpu's NPE_MDBLOCK_FUSED defaults to
# "off" (the port reads no environment). A caller picks the other through
# `mode`, which the models' `decode(..., mdblock_mode=)` and the sessions'
# `mdblock_mode` argument pass down. npe_tpu gives its kernel only the widths
# whose taps fit the TPU's VMEM; here "fused" means every MDBLOCK, and a shape
# the kernel cannot take raises.
MDBLOCK_MODE = "plain"
MDBLOCK_MODES = ("plain", "fused")


def mdblock(v, upd, name, x, scales, act, train, mode=None):
    """MDBLOCK (reference `layers.py:411-416`): the pre-activation residual
    act(BN2(x + MDCL2(act(BN1(MDCL1(act(BN0(x)))))))). With `train` the
    per-op form runs whatever the mode, as in npe_tpu: batch statistics do
    not fold to an affine. The fused form is the kernel's, whose activation
    is LRELU; in eager PyTorch it stacks both tap tensors and the affines
    from the weights on every call, and nothing is cached on a weight's
    identity."""
    mode = mode or MDBLOCK_MODE
    if mode not in MDBLOCK_MODES:
        raise ValueError(f"unknown MDBLOCK mode {mode!r}; the modes are {MDBLOCK_MODES}")
    if mode == "fused" and not train:
        if act is not LRELU:
            raise ValueError('the "fused" MDBLOCK computes LeakyReLU(0.2); another activation wants mode="plain"')
        taps1, taps2 = (_stacked_mdcl_taps(v, n, scales) for n in (name, f"{name}2"))
        affines = torch.stack([a for i in range(3) for a in _bn_affine(v, f"{name}bnorm{i}")])
        return mdblock_fused(x, taps1, taps2, affines, scales)
    h = act(bn(v, upd, f"{name}bnorm0", x, train))
    h = mdcl(v, name, h, scales)
    h = act(bn(v, upd, f"{name}bnorm1", h, train))
    h = mdcl(v, f"{name}2", h, scales)
    return act(bn(v, upd, f"{name}bnorm2", x + h, train))


def packed_head_weights(v, scales, block, as_taps):
    """What the two kernel forms of the head make of the weights on every
    call: (trunk, G_b taps, B_b taps). The tail's taps are the per-tap
    matrices of the composed G_b and B_b kernels in space-to-depth(block)
    form (`pack_head_taps`). The trunk (R, G_a and B_a read the same input,
    so they stack along the output channels: R alpha, R beta, G alpha, ...)
    is, for the fused kernel (`as_taps`), the three MDCLs' stacked taps
    (T, C, 6) for `tap_offsets(scales)`; for the hybrid form's library conv,
    the packed conv kernel of the composed 9x9 kernels. In eager PyTorch
    this runs on every decode (npe_tpu's jit folds it into the program). It
    is built from torch ops so that gradients reach the weights, and nothing
    is cached on a weight's identity, which training will update in place."""
    if as_taps:
        trunk = torch.cat([_stacked_mdcl_taps(v, n, scales) for n in ("R", "G_a", "B_a")], dim=2)
    else:
        k_trunk = torch.cat([_composed_mdcl_kernel(v, n, scales) for n in ("R", "G_a", "B_a")], dim=0)
        trunk = pack_kernel_s2d(k_trunk, block)
    k_g, k_b = (_composed_mdcl_kernel(v, n, scales) for n in ("G_b", "B_b"))
    return trunk, pack_head_taps(k_g, block), pack_head_taps(k_b, block)


def mdcl_multi(v, names, x, scales):
    """Several MDCL blocks over the SAME input fused into ONE conv: their
    composed multiscale kernels concatenate along the output-channel axis
    (reference `IAN.py:183-206`). Returns one output per name."""
    kernels = [_composed_mdcl_kernel(v, name, scales) for name in names]
    big = torch.cat(kernels, dim=0)
    out = conv2d(x, big, padding=big.shape[-1] // 2)
    return torch.split(out, [k.shape[0] for k in kernels], dim=1)


# The forms of the RGB-Beta head, all the same math
# (tests/test_torch_rgb_beta.py):
#   "plain"   the direct form: dense 9x9 convs at 64x64 with 6 / 2 / 2 outputs;
#   "hybrid"  the trunk as a packed space-to-depth(4) conv (a library conv, as
#             in npe_tpu, where XLA computes it), then the hand-written
#             `rgb_beta_tail` kernel;
#   "fused"   the whole head in the hand-written `rgb_beta_head` kernel
#             (npe_tpu calls this mode "pallas").
# The fused kernel's plain version, `ops.kernels.rgb_beta_head.
# rgb_beta_head_reference`, is all library calls: the trunk as one conv of its
# stacked taps placed at their offsets, then the tail as packed convs.
# HEAD_MODE is the form taken when the caller names none: a constant, the same
# on every device. (npe_tpu reads its default from NPE_HEAD_MODE, a TPU tuning
# switch; the port reads no environment.) A caller picks another form through
# `mode`, which the models' `decode(..., head_mode=)` and the sessions'
# `head_mode` argument pass down. On CPU tensors the kernels' wrappers run
# their plain versions.
HEAD_MODE = "hybrid"
HEAD_MODES = ("plain", "hybrid", "fused")


def rgb_beta_head(v, h, scales=(2, 3, 4), mode=None, block=4):
    """Autoregressive RGB-Beta output (reference `IAN.py:183-207`): R from
    trunk features; G from trunk + MDCL(R); B from trunk + MDCL([R, G]); each
    a sigmoid (alpha, beta) pair -> per-channel Beta mean. h: (N, C, H, W);
    returns (N, 3, H, W) in [-1, 1].

    The hybrid and fused forms keep the whole head in space-to-depth(block)
    form, component-major (`ops.conv.space_to_depth`): sigmoid and the Beta
    mean are per-element, so they commute with the packing. They need H and W
    divisible by `block` and whatever the kernels need (`pack_head_taps`: a
    3x3 cell footprint; the wrappers: block 4 and their shapes), and raise
    ValueError otherwise: only "plain" takes every shape, and only a caller
    who names it gets it."""
    scales = list(scales)
    mode = mode or HEAD_MODE
    if mode not in HEAD_MODES:
        raise ValueError(f"unknown RGB-Beta head mode {mode!r}; the modes are {HEAD_MODES}")
    if mode == "plain":
        r_pre, ga_pre, ba_pre = mdcl_multi(v, ["R", "G_a", "B_a"], h, scales)
        r = sigmoid(r_pre)
        g = sigmoid(ga_pre + mdcl(v, "G_b", r, scales))
        b = sigmoid(ba_pre + mdcl(v, "B_b", torch.cat([r, g], 1), scales))
        return torch.cat([beta_mean(c[:, 0:1], c[:, 1:2]) for c in (r, g, b)], dim=1)
    if h.shape[2] % block or h.shape[3] % block:
        raise ValueError(
            f"the {mode!r} RGB-Beta head wants H and W divisible by {block}, got {tuple(h.shape)}; "
            'only mode="plain" takes such a map'
        )
    if mode == "fused":
        return rgb_beta_head_kernel(h, *packed_head_weights(v, scales, block, as_taps=True), scales)
    k_trunk, tg_taps, tb_taps = packed_head_weights(v, scales, block, as_taps=False)
    trunk = conv2d(space_to_depth(h, block), k_trunk, padding=1)  # (N, 6*rr, H/r, W/r)
    return depth_to_space(rgb_beta_tail(trunk, tg_taps, tb_taps), block)


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
    """Discriminator-head parameters: minibatch discrimination over the
    pooled conv4 features, then the dense logits (`apply_discrim_head`)."""
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


def apply_discrim_head(v, c4):
    """GlobalPool -> minibatch discrimination -> dense LOGITS (the reference
    applies sigmoid/softmax in-layer; callers here apply it, keeping the
    training losses numerically stable). The minibatch features compare
    across the global batch of the data axis a training step has set."""
    f = minibatch_discrimination(
        global_avg_pool(c4),
        v["minibatch_discrim.theta"],
        v["minibatch_discrim.log_weight_scale"],
        v["minibatch_discrim.b"],
        axis=current_data_axis(),
    )
    return dense(f, v["discrimi.W"])


def unflatten_nchw(y, c, h, w):
    """Lasagne ReshapeLayer([0], C, H, W): a C-order reshape, already NCHW."""
    return y.reshape(y.shape[0], c, h, w)
