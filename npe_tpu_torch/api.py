"""Plat-style inference API -- the 5-method contract the NPE consumes
(npe_tpu `api.py`, reference `API.py`). Image arrays cross this boundary as
NCHW float32 in [-1, 1], as numpy; the brush box (c1, r1, c2, r2) is a
mask built from index ramps, so any box runs the same code. With
`dtype=torch.bfloat16` the model runs in bf16 (weights cast once, inputs cast
at the model's boundary), and every array that comes back is float32."""

import numpy as np
import torch

from npe_tpu_torch.models import get_config
from npe_tpu_torch.utils import checkpoints
from npe_tpu_torch.utils.cast import cast_floating, resolve_dtype
from npe_tpu_torch.utils.device import resolve_device


def patch_mask(h, w, c1, r1, c2, r2, dtype=torch.float32, device="cpu"):
    """(h, w) mask of the half-open box [r1, r2) x [c1, c2). The box is
    Python numbers or 0-d tensors on `device` (integer-valued; the captured
    editor keeps them in a float32 buffer); given tensors, nothing is read
    from the host."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    m = (rows >= r1) & (rows < r2) & (cols >= c1) & (cols < c2)
    return m.to(dtype)


def soft_patch_mask(h, w, c1, r1, c2, r2, sigma, dtype=torch.float32, device="cpu"):
    """Gaussian-feathered brush box (the reference's `gk` localizer,
    `NPE.py:167-175`): 1 inside the box, exp(-(dx^2 + dy^2) / (2 sigma^2 h))
    outside, where dx/dy are the pixel distances past the box edges.
    sigma == 0 gives the hard box exactly. The box and sigma are Python
    numbers or 0-d tensors on `device`: given tensors, nothing is read from
    the host (`torch.as_tensor` returns a tensor sigma of `dtype` as it is,
    and casts one of another dtype on the device), so a CUDA graph of it
    takes a new brush from its buffers."""
    rows = torch.arange(h, device=device, dtype=dtype)[:, None]
    cols = torch.arange(w, device=device, dtype=dtype)[None, :]
    dx = torch.clamp(torch.maximum(c1 - cols, cols - (c2 - 1)), min=0.0)
    dy = torch.clamp(torch.maximum(r1 - rows, rows - (r2 - 1)), min=0.0)
    sigma = torch.as_tensor(sigma, dtype=dtype, device=device)
    sig = torch.clamp(sigma, min=1e-6)  # keep exp() finite
    soft = torch.exp(-(dx**2 + dy**2) / (2.0 * sig**2 * h))
    hard = patch_mask(h, w, c1, r1, c2, r2, dtype, device)
    return torch.where(sigma > 0, soft, hard)


def decode_options(head_mode=None, mdblock_mode=None):
    """The keyword arguments a session passes to every `decode`: only the
    forms the caller named, so a model whose `decode` lacks one of them never
    receives it."""
    named = {"head_mode": head_mode, "mdblock_mode": mdblock_mode}
    return {k: v for k, v in named.items() if v is not None}


class IAN:
    """Generic class for using IAN-style models with the NPE
    (reference `API.py:11-110`)."""

    def __init__(
        self,
        config_path="IAN_simple",
        variables=None,
        weights_path=None,
        seed=42,
        device="cuda",
        head_mode=None,
        mdblock_mode=None,
        dtype=None,
    ):
        """head_mode: for a model with the RGB-Beta head, the form every
        decode takes (`models.common.HEAD_MODES`); mdblock_mode: for a model
        with MDBLOCKs, theirs (`models.common.MDBLOCK_MODES`). None leaves
        the model's default. dtype: torch.bfloat16 (or "bfloat16") runs the
        whole inference path in bf16, as npe_tpu's `dtype=jnp.bfloat16`: the
        weights, drawn or loaded in float32, are cast once, inputs are cast at
        the model's boundary, and outputs come back float32. None or float32
        runs in float32; any other dtype raises ValueError."""
        self.dtype = resolve_dtype(dtype)
        self.decode_options = decode_options(head_mode, mdblock_mode)
        self.device = resolve_device(device)
        self.module = get_config(config_path)
        self.cfg = self.module.cfg
        if variables is None:
            variables = self.module.init(torch.Generator().manual_seed(seed), self.device)
        if weights_path is not None:
            checkpoints.load_weights(weights_path, variables)
        if dtype is not None:
            variables = cast_floating(variables, self.dtype)
        self.variables = variables

    def _tensor(self, x):
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def _decode(self, z):
        """The model's decode of a float32 z, run in this model's dtype, widened
        to float32."""
        return self.module.decode(self.variables, z.to(self.dtype), **self.decode_options).float()

    def _patch_loss_grad(self, z, c1, r1, c2, r2, rgb=None):
        z = self._tensor(z).requires_grad_(True)
        xh = self._decode(z)  # (n, C, H, W)
        m = patch_mask(xh.shape[2], xh.shape[3], c1, r1, c2, r2, xh.dtype, self.device)
        if rgb is None:
            # mean of X_hat[0, :, r1:r2, c1:c2] (reference `API.py:59`)
            num = xh[0] * m
        else:
            # mean((RGB - X_hat)^2 over the patch) (reference `API.py:64`)
            num = (self._tensor(rgb)[0] - xh[0]) ** 2 * m
        loss = num.sum() / (m.sum() * xh.shape[1])
        (g,) = torch.autograd.grad(loss, z)
        return g.cpu().numpy()

    # --- plat contract -----------------------------------------------------

    @torch.no_grad()
    def encode_images(self, images):
        """images: (n, 3, s, s) in [-1, 1] -> (n, zdim)."""
        return self.module.encode(self.variables, self._tensor(images).to(self.dtype)).float().cpu().numpy()

    @torch.no_grad()
    def sample_at(self, z):
        """z: (n, zdim) -> images (n, 3, s, s) in [-1, 1]."""
        return self._decode(self._tensor(z)).cpu().numpy()

    def imgrad(self, c1, r1, c2, r2, z):
        """dZ that lightens the local patch (reference `API.py:66-70`)."""
        return self._patch_loss_grad(z, c1, r1, c2, r2)

    def imgradRGB(self, c1, r1, c2, r2, RGB, z):
        """dZ that moves the local patch toward RGB (reference `API.py:72-76`)."""
        return self._patch_loss_grad(z, c1, r1, c2, r2, RGB)

    def get_zdim(self):
        return self.cfg["num_latents"]
