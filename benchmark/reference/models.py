"""Plain PyTorch forms of the two IAN models the benchmark's configurations
name, written from the published description (ajbrock/Neural-Photo-Editor,
`IAN.py`, `IANv1.py`, `layers.py`; arXiv 1609.07093) and from nothing of the
program. They read the configuration file's widths and the flat variables
dict the benchmark makes (`init`), with the program's names and layouts:
conv kernels (cout, cin, kh, kw), deconv kernels (cin, cout, kh, kw), dense
weights (nin, nout) whose rows follow a map flattened as (H, W, C), MDCL
filters (cout, cin, 3, 3) with a coefficient per branch and output channel.

Departures from the program, each the same mathematics: an MDCL is the sum
of its branch convolutions (the undilated 3x3, the 1x1 of the filter's mean
for scale 0, a dilated 3x3 per scale), never a composed kernel; the RGB-Beta
head is three MDCLs at full resolution; the MDBLOCK is its six operations
one by one. Every product goes through `precision.Arith`.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Arith

BN_EPS = 1e-4
BN_ALPHA = 0.1
NON_TRAINABLE = (".mean", ".inv_std", ".weights_mask")


def lrelu(x):
    return F.leaky_relu(x, 0.2)


ACTIVATIONS = {"relu": F.relu, "lrelu": lrelu, "linear": lambda x: x}


# --- weights --------------------------------------------------------------


def made_masks(n, hidden, seed, n_shuffles):
    """The MADE masks (`mask_generator.py`, l = 0): an ordering from `seed`
    shuffled `n_shuffles` times, hidden connectivity its minimum. Returns the
    masks of the masked layers, then the direct input-to-output mask."""
    rng = np.random.RandomState(seed)
    ordering = np.arange(n)
    for _ in range(n_shuffles):
        ordering = rng.permutation(n)
    chain = [ordering + 1] + [np.full(h, (ordering + 1).min()) for h in hidden] + [ordering]
    layers = [(chain[i][:, None] <= chain[i + 1][None, :]).astype(np.float32) for i in range(len(chain) - 1)]
    return layers, (chain[0][:, None] <= chain[-1][None, :]).astype(np.float32)


def mdcl_fan_taps(coeffs):
    """Taps' worth of variance a composed MDCL pre-activation sees per input
    channel, from its branch coefficients {"base" | "1x1" | scale: value}."""
    mean_branch = coeffs.get("1x1", 0.0) / 9.0
    others = [c for k, c in coeffs.items() if k != "1x1"]
    return (sum(others) + mean_branch) ** 2 + 8 * mean_branch ** 2 + 8 * sum(c * c for c in others)


def coeff_name(scale):
    return "1x1" if scale == 0 else str(scale)


def layout(cfg):
    """[(name, shape, kind, extra)] of every variable of the configuration,
    kind one of "normal" (std in extra), "orthogonal" (gain), "zeros",
    "ones", "full" (value), "mask" (array)."""
    out = []
    enc, dec, head, dis, iaf = cfg["encoder"], cfg["decoder"], cfg["head"], cfg["discriminator"], cfg["iaf"]
    cin, zdim = cfg["image"][0], cfg["num_latents"]

    def bn(name, c):
        out.extend([(f"{name}.beta", (c,), "zeros", None), (f"{name}.gamma", (c,), "ones", None),
                    (f"{name}.mean", (c,), "zeros", None), (f"{name}.inv_std", (c,), "ones", None)])

    def he(fan, gain=2.0):
        return math.sqrt(gain / fan)

    def mdcl(name, ci, co, scales, gain):
        c0 = 1.0 / (1 + len(scales))
        coeffs = {"base": c0, **{coeff_name(s): c0 for s in scales}}
        out.append((f"{name}W", (co, ci, 3, 3), "normal", he(mdcl_fan_taps(coeffs) * ci, gain)))
        out.extend((f"{name}_coeff_{k}", (co,), "full", c0) for k in coeffs)

    widths = enc["widths"]
    k = enc["kernel"]
    for i, w in enumerate(widths, start=1):
        prev = cin if i == 1 else widths[i - 2]
        out.append((f"enc_conv{i}.W", (w, prev, k, k), "normal", he(k * k * prev)))
        if i == 1:
            out.append(("enc_conv1.b", (w,), "zeros", None))
        else:
            bn(f"bnorm{i}", w)
    flat = widths[-1] * (cfg["image"][1] // 2 ** len(widths)) ** 2
    out.append(("enc_fc1.W", (flat, enc["fc"]), "normal", he(flat)))
    bn("bnorm_enc_fc1", enc["fc"])
    for head_name, bn_name in (("enc_mu", "mu_bnorm"), ("enc_logsigma", "ls_bnorm")):
        out.append((f"{head_name}.W", (enc["fc"], zdim), "normal", he(enc["fc"])))
        bn(bn_name, zdim)

    layers, direct = made_masks(zdim, iaf["made_hidden"], iaf["mask_seed"], iaf["n_shuffles"])
    sizes = [zdim] + list(iaf["made_hidden"])
    for net in ("l_IAF_mu", "l_IAF_ls"):
        gain = math.sqrt(2.0) * (iaf["logsigma_gain"] if net == "l_IAF_ls" else 1.0)
        names = [f"{net}_input"] + [f"{net}_layer_{i}" for i in range(1, len(iaf["made_hidden"]))]
        for i, lname in enumerate(names):
            out.append((f"{lname}.W", (sizes[i], sizes[i + 1]), "orthogonal", math.sqrt(2.0)))
            out.append((f"{lname}.b", (sizes[i + 1],), "zeros", None))
        for suffix, nin in (("W", sizes[-1]), ("D", zdim)):
            out.append((f"{net}_output_{suffix}.W", (nin, zdim), "orthogonal", gain))
            out.append((f"{net}_output_{suffix}.b", (zdim,), "zeros", None))
        for lname, m in zip(names + [f"{net}_output_W", f"{net}_output_D"], layers + [direct]):
            out.append((f"{lname}.weights_mask", m.shape, "mask", m))

    fc_c = dec["fc_channels"]
    out.append(("l_dec_fc2.W", (zdim, fc_c * 16), "normal", he(zdim)))
    out.append(("l_dec_fc2.b", (fc_c * 16,), "zeros", None))
    chans = [fc_c] + list(dec["widths"])
    dk = dec["kernel"]
    if dec["kind"] == "mdblock":
        for i, scales in enumerate(dec["mdblock_scales"], start=1):
            name = f"dec_conv{i + 1}a"
            out.append((f"dec_conv{i}.W", (chans[i - 1], chans[i], dk, dk), "normal", he(dk * dk * chans[i - 1] / 4)))
            out.append((f"dec_conv{i}.b", (chans[i],), "zeros", None))
            mdcl(name, chans[i], chans[i], scales, 1.0)
            mdcl(f"{name}2", chans[i], chans[i], scales, 1.0)
            for j in range(3):
                bn(f"{name}bnorm{j}", chans[i])
        last = len(dec["mdblock_scales"]) + 1
        out.append((f"dec_conv{last}.W", (chans[-1], dec["last_width"], dk, dk), "normal",
                    he(dk * dk * chans[-1] / 4)))
        bn(f"bnorm_dc{last}", dec["last_width"])
        top = dec["last_width"]
    elif dec["kind"] == "bn_relu":
        for i in range(1, len(chans)):
            out.append((f"dec_conv{i}.W", (chans[i - 1], chans[i], dk, dk), "normal", he(dk * dk * chans[i - 1] / 4)))
            bn(f"bnorm_dc{i}", chans[i])
        top = chans[-1]
    else:
        raise ValueError(f"decoder kind {dec['kind']!r}")
    for name, ci in (("R", top), ("G_a", top), ("G_b", 2), ("B_a", top), ("B_b", 4)):
        mdcl(name, ci, 2, head["scales"], 2.0)

    feat, nk, dpk = widths[-1], dis["minibatch_kernels"], dis["minibatch_dim"]
    out.append(("minibatch_discrim.theta", (feat, nk, dpk), "normal", 0.05))
    out.append(("minibatch_discrim.log_weight_scale", (nk, dpk), "zeros", None))
    out.append(("minibatch_discrim.b", (nk,), "full", -1.0))
    out.append(("discrimi.W", (feat + nk, dis["classes"]), "normal", he(feat + nk)))
    return out


def init(cfg, seed, device):
    """The configuration's variables (name -> float32 tensor on `device`),
    drawn on `device` from a torch.Generator seeded by `seed`, in two draws:
    every normal kernel at its unit-gain std (He's sqrt(2 / fan_in); a
    stride-2 deconv output sees a quarter of its taps; an MDBLOCK's two
    filters sqrt(1 / fan) on their residual branch; `mdcl_fan_taps` taps an
    input channel for an MDCL), and every MADE weight orthogonal at gain
    sqrt(2) (the IAF log-sigma net's outputs times `iaf.logsigma_gain`).
    Biases, BN state and MDCL coefficients as the models initialise them."""
    spec = layout(cfg)
    g = torch.Generator(device).manual_seed(int(seed))
    normal = [(n, s, std) for n, s, kind, std in spec if kind == "normal"]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g, device=device)
    ortho = [(n, s, gain) for n, s, kind, gain in spec if kind == "orthogonal"]
    side = max(max(s) for _, s, _ in ortho)
    q, r = torch.linalg.qr(torch.randn((len(ortho), side, side), generator=g, device=device))
    q = q * torch.sign(torch.diagonal(r, dim1=1, dim2=2))[:, None, :]
    v, at = {}, 0
    drawn = {}
    for n, s, std in normal:
        size = math.prod(s)
        drawn[n] = (flat[at:at + size] * std).view(s)
        at += size
    for i, (n, s, gain) in enumerate(ortho):
        drawn[n] = q[i, :s[0], :s[1]] * gain
    for n, s, kind, extra in spec:
        if n in drawn:
            v[n] = drawn[n].clone()
        elif kind == "zeros":
            v[n] = torch.zeros(s, device=device)
        elif kind == "ones":
            v[n] = torch.ones(s, device=device)
        elif kind == "full":
            v[n] = torch.full(s, float(extra), device=device)
        else:
            v[n] = torch.from_numpy(extra).to(device)
    return v


def is_trainable(name):
    return not name.endswith(NON_TRAINABLE)


# --- layers ----------------------------------------------------------------


class Model:
    """The configuration's model over variables `v` in `precision`."""

    def __init__(self, cfg, precision="float32"):
        self.cfg = cfg
        self.ar = Arith(precision)

    # building blocks
    def bn(self, v, name, x, train, upd):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        beta, gamma = v[f"{name}.beta"], v[f"{name}.gamma"]
        if not train:
            return (x - v[f"{name}.mean"].view(shape)) * (gamma * v[f"{name}.inv_std"]).view(shape) + beta.view(shape)
        axes = (0,) if x.ndim == 2 else (0, 2, 3)
        mu = x.mean(dim=axes)
        istd = torch.rsqrt(x.var(dim=axes, unbiased=False) + BN_EPS)
        if upd is not None:
            upd[f"{name}.mean"] = ((1 - BN_ALPHA) * v[f"{name}.mean"] + BN_ALPHA * mu).detach()
            upd[f"{name}.inv_std"] = ((1 - BN_ALPHA) * v[f"{name}.inv_std"] + BN_ALPHA * istd).detach()
        return (x - mu.view(shape)) * (gamma * istd).view(shape) + beta.view(shape)

    def dense(self, x, w, b=None):
        if x.ndim == 4:
            x = x.permute(0, 2, 3, 1)
        y = self.ar.matmul(x.reshape(x.shape[0], -1), w)
        return y if b is None else y + b

    def conv_s2(self, x, w, b=None):
        y = self.ar.conv(x, w, stride=2, padding=w.shape[-1] // 2)
        return y if b is None else y + b.view(1, -1, 1, 1)

    def deconv(self, x, w, b=None):
        k = w.shape[-1]
        y = self.ar.deconv(x, w, 2, k // 2, 2 + 2 * (k // 2) - k)
        return y if b is None else y + b.view(1, -1, 1, 1)

    def mdcl(self, v, name, x, scales):
        """The branch sum of `layers.py`'s MDCL, 'same' padding."""
        w = v[f"{name}W"]

        def coeff(key):
            return v[f"{name}_coeff_{key}"].view(1, -1, 1, 1)

        out = coeff("base") * self.ar.conv(x, w, padding=1)
        for s in scales:
            if s == 0:
                out = out + coeff("1x1") * self.ar.conv(x, w.mean(dim=(2, 3), keepdim=True))
            else:
                out = out + coeff(str(s)) * self.ar.conv(x, w, padding=s, dilation=s)
        return out

    def mdblock(self, v, name, x, scales, train, upd):
        h = lrelu(self.bn(v, f"{name}bnorm0", x, train, upd))
        h = lrelu(self.bn(v, f"{name}bnorm1", self.mdcl(v, name, h, scales), train, upd))
        h = self.mdcl(v, f"{name}2", h, scales)
        return lrelu(self.bn(v, f"{name}bnorm2", x + h, train, upd))

    # the model
    def backbone(self, v, x, train=False, upd=None):
        feats, h = [], x
        for i in range(1, len(self.cfg["encoder"]["widths"]) + 1):
            h = self.conv_s2(h, v[f"enc_conv{i}.W"], v.get(f"enc_conv{i}.b"))
            h = lrelu(h if i == 1 else self.bn(v, f"bnorm{i}", h, train, upd))
            feats.append(h)
        return feats

    def encode_stats(self, v, x, train=False, upd=None):
        feats = self.backbone(v, x, train, upd)
        act = ACTIVATIONS[self.cfg["encoder"]["fc_act"]]
        f = act(self.bn(v, "bnorm_enc_fc1", self.dense(feats[-1], v["enc_fc1.W"]), train, upd))
        mu = self.bn(v, "mu_bnorm", self.dense(f, v["enc_mu.W"]), train, upd)
        ls = self.bn(v, "ls_bnorm", self.dense(f, v["enc_logsigma.W"]), train, upd)
        return mu, ls, feats

    def made(self, v, net, z):
        h = z
        names = [f"{net}_input"] + [f"{net}_layer_{i}" for i in range(1, len(self.cfg["iaf"]["made_hidden"]))]
        for lname in names:
            h = F.relu(self.dense(h, v[f"{lname}.W"] * v[f"{lname}.weights_mask"], v[f"{lname}.b"]))
        out = self.dense(h, v[f"{net}_output_W.W"] * v[f"{net}_output_W.weights_mask"], v[f"{net}_output_W.b"])
        return out + self.dense(z, v[f"{net}_output_D.W"] * v[f"{net}_output_D.weights_mask"], v[f"{net}_output_D.b"])

    def iaf(self, v, z):
        """`IAFLayer`: (z - mu(z)) / exp(logsigma(z))."""
        return (z - self.made(v, "l_IAF_mu", z)) / torch.exp(self.made(v, "l_IAF_ls", z))

    def encode(self, v, x):
        return self.iaf(v, self.encode_stats(v, x)[0])

    def head(self, v, h):
        """The autoregressive RGB-Beta head (`IAN.py:183-207`)."""
        sc = self.cfg["head"]["scales"]
        r = torch.sigmoid(self.mdcl(v, "R", h, sc))
        g = torch.sigmoid(self.mdcl(v, "G_a", h, sc) + self.mdcl(v, "G_b", r, sc))
        b = torch.sigmoid(self.mdcl(v, "B_a", h, sc) + self.mdcl(v, "B_b", torch.cat([r, g], 1), sc))
        return torch.cat([2.0 * (c[:, 0:1] / (c[:, 0:1] + c[:, 1:2] + 1e-8)) - 1.0 for c in (r, g, b)], dim=1)

    def decode(self, v, z, train=False, upd=None):
        """Post-IAF latents (N, zdim) -> images (N, 3, H, W) in [-1, 1]."""
        dec = self.cfg["decoder"]
        y = ACTIVATIONS[dec["fc_act"]](self.dense(z, v["l_dec_fc2.W"], v["l_dec_fc2.b"]))
        h = y.reshape(y.shape[0], dec["fc_channels"], 4, 4)
        if dec["kind"] == "mdblock":
            for i, scales in enumerate(dec["mdblock_scales"], start=1):
                h = self.deconv(h, v[f"dec_conv{i}.W"], v[f"dec_conv{i}.b"])
                h = self.mdblock(v, f"dec_conv{i + 1}a", h, scales, train, upd)
            last = len(dec["mdblock_scales"]) + 1
            h = lrelu(self.bn(v, f"bnorm_dc{last}", self.deconv(h, v[f"dec_conv{last}.W"]), train, upd))
        else:
            for i in range(1, len(dec["widths"]) + 1):
                h = F.relu(self.bn(v, f"bnorm_dc{i}", self.deconv(h, v[f"dec_conv{i}.W"]), train, upd))
        return self.head(v, h)

    def discrim_logits(self, v, c4):
        """Global pool, minibatch discrimination (`layers.py:486-524`), dense."""
        x = c4.mean(dim=(2, 3))
        theta = v["minibatch_discrim.theta"]
        w = theta * (torch.exp(v["minibatch_discrim.log_weight_scale"]) / torch.sqrt((theta ** 2).sum(dim=0)))[None]
        act = self.ar.matmul(x, w.reshape(w.shape[0], -1)).reshape(x.shape[0], *w.shape[1:])  # (N, K, D)
        dist = (act[:, :, :, None] - act.permute(1, 2, 0)[None]).abs().sum(dim=2)  # (N, K, N)
        dist = dist + 1e6 * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)[:, None, :]
        f = torch.exp(-dist).sum(dim=2) + v["minibatch_discrim.b"]
        return self.dense(torch.cat([x, f], dim=1), v["discrimi.W"])
