"""The IAN family's convolutions, on NCHW activations.

npe_tpu lowers them to `lax.conv_general_dilated` (XLA ops, not Pallas
kernels), so here they go to `F.conv2d` / `F.conv_transpose2d`. Its TPU mode
switches (`NPE_DECONV_MODE`, `NPE_ENC_BWD`) reorganise the same math for the
TPU and have no counterpart. Kernel layouts are the port's
(`utils/checkpoints.from_reference`): conv (cout, cin, kh, kw), deconv
(cin, cout, kh, kw).

Space-to-depth: npe_tpu packs NHWC maps position-major, packed channel
(p*r + q)*C + c for the in-block pixel offset (p, q). The port packs NCHW maps
COMPONENT-major, packed channel c*r*r + p*r + q, which is
`F.pixel_unshuffle`'s order: each original channel becomes r*r neighbouring
planes. `pack_kernel_s2d` uses the same order on both channel axes.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size, window, stride, dilation=1):
    """XLA's "SAME" padding of one spatial axis: (lo, hi), the output
    ceil(size / stride) long, the odd pixel at the end."""
    eff = (window - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _explicit_pads(x, window, stride, padding, dilation=(1, 1)):
    """npe_tpu's padding argument ("SAME", "VALID", an int, or per-axis
    (lo, hi) pairs) as ((lo, hi), (lo, hi)) for the H and W of NCHW x."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"padding {padding!r}: 'SAME', 'VALID', an int or ((lo, hi), (lo, hi))")
        return tuple(_same_pads(x.shape[2 + i], window[i], stride[i], dilation[i]) for i in range(2))
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    return tuple(_pair(p) for p in padding)


def conv2d(x, w, b=None, padding=0, dilation=1, stride=1):
    """Cross-correlation (npe_tpu `ops/conv.py:conv2d`, cuDNN's
    flip_filters=False). x: (N, Cin, H, W); w: (Cout, Cin, kh, kw); padding:
    an int, "SAME", "VALID" or ((lo, hi), (lo, hi)) as npe_tpu takes it."""
    stride, dilation = _pair(stride), _pair(dilation)
    if isinstance(padding, int):
        return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation)
    (t, bo), (le, r) = _explicit_pads(x, w.shape[2:], stride, padding, dilation)
    if t == bo and le == r:
        return F.conv2d(x, w, b, stride=stride, padding=(t, le), dilation=dilation)
    return F.conv2d(F.pad(x, (le, r, t, bo)), w, b, stride=stride, dilation=dilation)


def dilated_conv2d(x, w, dilation, padding=None):
    """Dilated conv (npe_tpu `ops/conv.py:dilated_conv2d`); the default
    padding keeps the spatial size, ((e - 1) // 2, e // 2) for the dilated
    extent e."""
    d = _pair(dilation)
    if padding is None:
        eff = [k + (k - 1) * (di - 1) for k, di in zip(w.shape[2:], d)]
        padding = tuple(((e - 1) // 2, e // 2) for e in eff)
    return conv2d(x, w, padding=padding, dilation=d)


def avg_pool(x, window, stride, padding="VALID", count_include_pad=False):
    """Average pooling over NCHW spatial dims (npe_tpu
    `ops/conv.py:avg_pool`): with "SAME" or explicit padding and
    count_include_pad=False, each window's mean over the pixels it covers."""
    window, stride = _pair(window), _pair(stride)
    (t, bo), (le, r) = _explicit_pads(x, window, stride, padding)
    padded = F.pad(x, (le, r, t, bo))
    area = window[0] * window[1]
    summed = F.avg_pool2d(padded, window, stride) * area
    if count_include_pad or (t, bo, le, r) == (0, 0, 0, 0):
        return summed / area
    ones = F.pad(torch.ones_like(x[:1, :1]), (le, r, t, bo))
    return summed / (F.avg_pool2d(ones, window, stride) * area)


def max_pool(x, window, stride, padding="VALID"):
    """Max pooling over NCHW spatial dims (npe_tpu `ops/conv.py:max_pool`);
    padding never wins a max."""
    window, stride = _pair(window), _pair(stride)
    (t, bo), (le, r) = _explicit_pads(x, window, stride, padding)
    return F.max_pool2d(F.pad(x, (le, r, t, bo), value=float("-inf")), window, stride)


def upscale2d(x, factor):
    """Nearest-neighbour upscale (Lasagne Upscale2DLayer, npe_tpu
    `ops/conv.py:upscale2d`)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def enc_conv2d(x, w, b=None):
    """The encoder's 5x5 stride-2 pad-2 cross-correlation (npe_tpu
    `ops/conv.py:enc_conv2d`)."""
    return F.conv2d(x, w, b, stride=2, padding=2)


def deconv2d(x, w, b=None, stride=2, crop=2):
    """DCGAN-style transposed conv with the reference DeconvLayer's geometry,
    output spatial = stride x input spatial (npe_tpu `ops/conv.py:deconv2d`
    / `deconv2d_phased`): the models' k=5, stride 2, crop 2 by default. w
    (cin, cout, kh, kw) holds the forward taps unflipped, as npe_tpu's do."""
    return F.conv_transpose2d(x, w, b, stride=stride, padding=crop, output_padding=stride + 2 * crop - w.shape[2])


def space_to_depth(x, r):
    """(N, C, H, W) -> (N, C*r*r, H/r, W/r); packed channel index =
    c*r*r + p*r + q for in-block pixel offset (p, q). Inverse of
    `depth_to_space`."""
    return F.pixel_unshuffle(x, r)


def depth_to_space(y, r):
    """(N, C*r*r, H, W) -> (N, C, H*r, W*r), inverse of `space_to_depth`."""
    return F.pixel_shuffle(y, r)


def s2d_block_taps(ksize, r):
    """Spatial tap count of the packed (space-to-depth) form of an odd
    `ksize` 'same' conv at block factor r."""
    return 2 * -(-(ksize // 2) // r) + 1


# built outside inference mode: a constant first built under a server's
# inference_mode would be an inference tensor, which no later autograd graph
# may save for its backward
@functools.lru_cache(maxsize=32)
@torch.inference_mode(False)
def _s2d_gather(ksize, r, device):
    """For `pack_kernel_s2d`: which dense tap (flat index dy*K + dx) each
    packed tap reads, as (index, mask), both flat over (a, b, p, q, u, v):
    output offset (a, b), input offset (p, q), packed tap (u, v). Built once
    per (K, r, device)."""
    half = ksize // 2
    t = s2d_block_taps(ksize, r)
    tc = t // 2
    # Output pixel y = r*i + a reads input row r*(i + u - tc) + p, i.e. dense
    # tap dy = r*(u - tc) + p - a + half; taps outside [0, K) are zeros.
    u = np.arange(t)[None, None, :]
    p = np.arange(r)[None, :, None]
    a = np.arange(r)[:, None, None]
    d = r * (u - tc) + p - a + half  # (a, p, u)
    valid = (d >= 0) & (d < ksize)
    dc = np.clip(d, 0, ksize - 1)
    # (a, b, p, q, u, v): rows from (a, p, u), columns from (b, q, v)
    idx = dc[:, None, :, None, :, None] * ksize + dc[None, :, None, :, None, :]
    mask = valid[:, None, :, None, :, None] & valid[None, :, None, :, None, :]
    return (
        torch.from_numpy(idx.reshape(-1)).to(device),
        torch.from_numpy(mask.reshape(-1).astype(np.float32)).to(device),
    )


def pack_kernel_s2d(k, r):
    """Repack a dense odd-sized 'same' conv kernel (Cout, Cin, K, K) into the
    equivalent kernel over space-to-depth inputs and outputs:
    (r*r*Cout, r*r*Cin, T, T) with T = s2d_block_taps(K, r), both channel
    axes component-major (co*r*r + a*r + b and ci*r*r + p*r + q), the order
    of `space_to_depth`. Each dense tap maps to exactly one packed tap; packed
    taps that fall outside the dense kernel are zeros.

    conv2d(space_to_depth(x, r), pack_kernel_s2d(k, r), padding=T // 2)
    == space_to_depth(conv2d(x, k, padding=K // 2), r) for H and W divisible
    by r. Per call this is a gather, a multiply and a permuted copy, all
    differentiable with respect to k."""
    cout, cin, ksize, _ = k.shape
    t = s2d_block_taps(ksize, r)
    idx, mask = _s2d_gather(ksize, r, k.device)
    kk = k.reshape(cout, cin, ksize * ksize).index_select(2, idx) * mask.to(k.dtype)
    kk = kk.reshape(cout, cin, r, r, r, r, t, t)  # (co, ci, a, b, p, q, u, v)
    return kk.permute(0, 2, 3, 1, 4, 5, 6, 7).reshape(r * r * cout, r * r * cin, t, t)


def global_avg_pool(x):
    """GlobalPoolLayer (reference `IAN_simple.py:225`): NCHW -> NC."""
    return x.mean(dim=(2, 3))
