"""npe_tpu_torch: the PyTorch and CUDA port of `npe_tpu` (Neural Photo Editor +
Introspective Adversarial Networks), for NVIDIA Hopper GPUs.

Module paths and names mirror `npe_tpu`, so each piece has an obvious
counterpart there, which is the reference its tests hold it against. Inside,
the port uses PyTorch idiom:

  * plain functions over a flat, name-keyed dict of tensors with the same
    Lasagne names (`enc_conv1.W`, `bnorm2.inv_std`, ...);
  * NCHW activations; conv kernels (cout, cin, kh, kw) and deconv kernels
    (cin, cout, kh, kw), as `F.conv2d` / `F.conv_transpose2d` take them.
    Files on disk keep `npe_tpu`'s layout (`utils/checkpoints.py`);
  * an explicit `device` and an explicit `torch.Generator`.

Entry points (`api.IAN`, `editor.EditSession`) run on the GPU unless the
caller passes `device="cpu"`; without a CUDA device they raise.

Layout:
    npe_tpu_torch.ops      -- layers, filters, and the hand-written CUDA kernels
                              (`ops/kernels/`, sources under `csrc/`)
    npe_tpu_torch.models   -- IAN_simple, IANv1 (MADE/IAF latents, RGB-Beta head)
    npe_tpu_torch.api      -- plat-style inference API
    npe_tpu_torch.editor   -- headless edit engine
    npe_tpu_torch.utils    -- checkpoints, ranges, device selection, GPU timing
"""

__version__ = "0.1.0"

from npe_tpu_torch.utils.ranges import from_tanh, to_tanh  # noqa: F401
