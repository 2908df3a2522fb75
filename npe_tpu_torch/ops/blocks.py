"""Library-extra blocks of the reference layer library (npe_tpu
`ops/blocks.py`): the MDC upsample and downsample prototypes (`USL` / `DSL`,
`layers.py:262-391`), inception-style blocks (`layers.py:527-607`) and the
residual sugar `ResLayer` (`layers.py:636-637`). None of the three models
uses them. Parameter names are npe_tpu's; activations are NCHW and kernels
in the port's layouts: conv and MDCL (cout, cin, kh, kw), dense (nin, nout).
Branches that differ in geometry (upsample, pooling) stay separate library
convs, as npe_tpu leaves them to XLA.
"""

import torch

from npe_tpu_torch.ops.activations import elu
from npe_tpu_torch.ops.conv import avg_pool, conv2d, deconv2d, dilated_conv2d, max_pool, upscale2d
from npe_tpu_torch.ops.initializers import normal
from npe_tpu_torch.ops.linear import dense
from npe_tpu_torch.ops.mdcl import mdcl_apply


def _coeff(v, name, s):
    return v[f"{name}_coeff_{'1x1' if s == 0 else s}"]


def usl_init(vb, name, cin, cout, scales, std=0.02):
    """MDC upsample block parameters (reference `USL`, `layers.py:262-325`):
    one shared 3x3 W, per-branch coefficients and a deconv coefficient."""
    vb.mdcl(name, cin, cout, scales, std=std)
    vb.v[f"{name}_coeff_deconv"] = torch.full((cout,), 1.0 / (1 + len(scales)), device=vb.device)


def usl_apply(v, name, x, scales):
    """Upscale2D, then the MDCL branches on the upscaled input, plus a
    stride-2 deconv (crop 1) of the shared filter, all summed."""
    out = mdcl_apply(upscale2d(x, 2), v[f"{name}W"], v[f"{name}_coeff_base"],
                     {s: _coeff(v, name, s) for s in scales}, scales)
    # the shared (cout, cin) filter as a transposed conv's (cin, cout) kernel
    w = (v[f"{name}W"] * v[f"{name}_coeff_deconv"][:, None, None, None]).transpose(0, 1)
    return out + deconv2d(x, w, stride=2, crop=1)


def dsl_init(vb, name, cin, cout, scales, std=0.02):
    """MDC downsample block parameters (reference `DSL`, `layers.py:331-391`)."""
    vb.mdcl(name, cin, cout, scales, std=std)


def dsl_apply(v, name, x, scales):
    """A stride-2 3x3 conv, [avg-pool(scale) -> 3x3 conv] branches and a 1x1
    stride-2 mean-filter conv, summed (the reference's geometry, its ad-hoc
    pool padding regularised to "SAME", as npe_tpu does)."""
    w = v[f"{name}W"]
    out = conv2d(x, w * v[f"{name}_coeff_base"][:, None, None, None], stride=2, padding=1)
    for s in scales:
        if s == 0:
            continue
        p = avg_pool(x, s, 2, padding="SAME")
        out = out + conv2d(p, w * _coeff(v, name, s)[:, None, None, None], padding=1)
    if 0 in scales:
        w1 = w.mean(dim=(2, 3), keepdim=True) * _coeff(v, name, 0)[:, None, None, None]
        out = out + conv2d(x, w1, stride=2, padding=0)
    return out


def res_layer(x, block_out, nonlinearity):
    """`ResLayer` (`layers.py:636-637`): NL(x + block(x))."""
    return nonlinearity(x + block_out)


# --- inception-style blocks (`layers.py:527-607`) -----------------------------


def pd(num_layers=2, num_filters=32, filter_size=3, pad=1, stride=1, nonlinearity=elu, style="convolutional",
       bnorm=1, **kwargs):
    """Param-dict generator (reference `pd`, `layers.py:604-607`): scalars
    broadcast to per-layer lists."""
    args = dict(num_filters=num_filters, filter_size=filter_size, pad=pad, stride=stride,
                nonlinearity=nonlinearity, style=style, bnorm=bnorm, **kwargs)
    return {k: (v if isinstance(v, list) else [v] * num_layers) for k, v in args.items()}


def inception_init(vb, name, cin, param_dicts):
    """Parameters of an inception block: one branch per dict, each a stack
    of conv / dilation / dense steps with optional batch norm."""
    for i, d in enumerate(param_dicts):
        ch = cin
        for j, style in enumerate(d["style"]):
            lname = f"{name}_{i}_{j}"
            nf, fs = d["num_filters"][j], d["filter_size"][j]
            if style in ("convolutional", "dilation"):
                vb.v[f"{lname}.W"] = normal(0.02)(vb.gen, (nf, ch, fs, fs), vb.device)
                vb.v[f"{lname}.b"] = torch.zeros(nf, device=vb.device)
                ch = nf
            elif style == "dense":
                # on flattened features; the caller knows the geometry
                vb.v[f"{lname}.W"] = normal(0.02)(vb.gen, (ch, nf), vb.device)
                vb.v[f"{lname}.b"] = torch.zeros(nf, device=vb.device)
                ch = nf
            # 'pool' has no parameters
            if d["bnorm"][j]:
                vb.bn(f"{name}_bnorm_{i}_{j}", ch)


def inception_apply(v, upd, name, x, param_dicts, train=False, upscale=False):
    """Run the block: the channel concatenation of its branches' outputs
    (reference `InceptionLayer` / `InceptionUpscaleLayer`)."""
    from npe_tpu_torch.models.common import bn as bn_apply

    outs = []
    for i, d in enumerate(param_dicts):
        h = x
        for j, style in enumerate(d["style"]):
            lname = f"{name}_{i}_{j}"
            nl, stride = d["nonlinearity"][j], d["stride"][j]
            padv = d.get("pad", [0] * len(d["style"]))[j]
            if style == "convolutional":
                w, b = v[f"{lname}.W"], v[f"{lname}.b"]
                if upscale and stride > 1:
                    h = deconv2d(h, w.transpose(0, 1), b, stride=stride, crop=padv)
                else:
                    h = conv2d(h, w, b, padding=padv, stride=1 if upscale else stride)
            elif style == "dilation":
                h = dilated_conv2d(h, v[f"{lname}.W"], d["dilation"][j])
            elif style == "pool":
                mode = d.get("mode", ["average_exc_pad"] * len(d["style"]))[j]
                pool = max_pool if mode == "max" else avg_pool
                if upscale:
                    h = pool(upscale2d(h, stride), d["filter_size"][j], 1, padding="SAME")
                else:
                    h = pool(h, d["filter_size"][j], stride, padding="SAME")
            elif style == "dense":
                h = dense(h, v[f"{lname}.W"], v[f"{lname}.b"])
            if nl is not None:
                h = nl(h)
            if d["bnorm"][j]:
                h = bn_apply(v, upd, f"{name}_bnorm_{i}_{j}", h, train)
        outs.append(h)
    return torch.cat(outs, dim=1)
