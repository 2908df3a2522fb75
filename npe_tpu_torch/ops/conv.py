"""The IAN family's two convolutions, on NCHW activations.

npe_tpu lowers both to `lax.conv_general_dilated` (XLA ops, not Pallas
kernels), so here they go to `F.conv2d` / `F.conv_transpose2d`. Its TPU mode
switches (`NPE_DECONV_MODE`, `NPE_ENC_BWD`) reorganise the same math for the
TPU and have no counterpart. Kernel layouts are the port's
(`utils/checkpoints.from_reference`): conv (cout, cin, kh, kw), deconv
(cin, cout, kh, kw).
"""

import torch.nn.functional as F


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
