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


def conv2d(x, w, b=None, padding=0, dilation=1):
    """Stride-1 cross-correlation with explicit zero padding (npe_tpu
    `ops/conv.py:conv2d`). x: (N, Cin, H, W); w: (Cout, Cin, kh, kw)."""
    return F.conv2d(x, w, b, stride=1, padding=padding, dilation=dilation)


def enc_conv2d(x, w, b=None):
    """The encoder's 5x5 stride-2 pad-2 cross-correlation (npe_tpu
    `ops/conv.py:enc_conv2d`)."""
    return F.conv2d(x, w, b, stride=2, padding=2)


def deconv2d(x, w, b=None):
    """DCGAN-style transposed conv with the reference DeconvLayer's geometry:
    k=5, stride 2, crop 2, output spatial = 2 x input spatial (npe_tpu
    `ops/conv.py:deconv2d` / `deconv2d_phased`). w holds the forward taps
    unflipped, as npe_tpu's do."""
    return F.conv_transpose2d(x, w, b, stride=2, padding=2, output_padding=1)


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


@functools.lru_cache(maxsize=32)
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
