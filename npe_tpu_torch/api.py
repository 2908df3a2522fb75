"""Plat-style inference API -- the 5-method contract the NPE consumes
(npe_tpu `api.py`, reference `API.py`). Image arrays cross this boundary as
NCHW float32 in [-1, 1], as numpy; the brush box (c1, r1, c2, r2) is a
mask built from index ramps, so any box runs the same code. With
`dtype=torch.bfloat16` the model runs in bf16 (weights cast once, inputs cast
at the model's boundary), and every array that comes back is float32.

As in npe_tpu, where each method is one jitted program per input shape, each
method is one program per input shape (`utils/graphs.ProgramCache`): on the
card a CUDA graph, captured at the first call of a shape and replayed at
every later one; the box and the RGB target are inputs in device buffers, so
a moved or resized brush, a new colour or new latents never capture again.
No batch is padded. On the CPU, or with `eager=True`, the same bodies run
directly on the same buffers.
"""

import numpy as np
import torch

from npe_tpu_torch.models import get_config
from npe_tpu_torch.utils import checkpoints
from npe_tpu_torch.utils.graphs import ProgramCache
from npe_tpu_torch.utils.cast import cast_floating, resolve_dtype
from npe_tpu_torch.utils.device import resolve_device
from npe_tpu_torch.utils.profiling import annotate


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
        eager=False,
    ):
        """head_mode: for a model with the RGB-Beta head, the form every
        decode takes (`models.common.HEAD_MODES`); mdblock_mode: for a model
        with MDBLOCKs, theirs (`models.common.MDBLOCK_MODES`). None leaves
        the model's default. dtype: torch.bfloat16 (or "bfloat16") runs the
        whole inference path in bf16, as npe_tpu's `dtype=jnp.bfloat16`: the
        weights, drawn or loaded in float32, are cast once, inputs are cast at
        the model's boundary, and outputs come back float32. None or float32
        runs in float32; any other dtype raises ValueError. eager: on the
        card, run the methods' bodies without CUDA graphs (for comparisons
        and timings; the CPU never has graphs)."""
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
        self.programs = ProgramCache(self.device, eager)
        self.programs.define("encode", self._encode)
        self.programs.define("sample", self._sample)
        # imgrad takes (z, box), imgrad_rgb (z, box, rgb)
        self.programs.define("imgrad", self._patch_loss_grad)
        self.programs.define("imgrad_rgb", self._patch_loss_grad)

    # --- the bodies (tensors on the device in, tensors out) --------------------

    @torch.no_grad()
    def _encode(self, x):
        return self.module.encode(self.variables, x.to(self.dtype)).float()

    @torch.no_grad()
    def _sample(self, z):
        return self._decode(z)

    def _decode(self, z):
        """The model's decode of a float32 z, run in this model's dtype, widened
        to float32."""
        return self.module.decode(self.variables, z.to(self.dtype), **self.decode_options).float()

    def _patch_loss_grad(self, z, box, rgb=None):
        """d(patch loss)/dz through the decoder; box (c1, r1, c2, r2) a float32
        vector on the device, so nothing is read from the host. The gradient
        runs whatever the caller's grad mode."""
        with torch.inference_mode(False), torch.enable_grad():
            z = z.detach().requires_grad_(True)
            xh = self._decode(z)  # (n, C, H, W)
            m = patch_mask(xh.shape[2], xh.shape[3], *box.unbind(), xh.dtype, self.device)
            if rgb is None:
                # mean of X_hat[0, :, r1:r2, c1:c2] (reference `API.py:59`)
                num = xh[0] * m
            else:
                # mean((RGB - X_hat)^2 over the patch) (reference `API.py:64`)
                num = (rgb[0] - xh[0]) ** 2 * m
            loss = num.sum() / (m.sum() * xh.shape[1])
            (g,) = torch.autograd.grad(loss, z)
        return g

    # --- plat contract -----------------------------------------------------

    def encode_images(self, images):
        """images: (n, 3, s, s) in [-1, 1] -> (n, zdim)."""
        with annotate("npe.encode_images"):
            return self.programs("encode", np.asarray(images, np.float32))

    def sample_at(self, z):
        """z: (n, zdim) -> images (n, 3, s, s) in [-1, 1]."""
        with annotate("npe.sample_at"):
            return self.programs("sample", np.asarray(z, np.float32))

    def imgrad(self, c1, r1, c2, r2, z):
        """dZ that lightens the local patch (reference `API.py:66-70`)."""
        return self.programs("imgrad", np.asarray(z, np.float32), np.float32([c1, r1, c2, r2]))

    def imgradRGB(self, c1, r1, c2, r2, RGB, z):
        """dZ that moves the local patch toward RGB (reference `API.py:72-76`)."""
        return self.programs("imgrad_rgb", np.asarray(z, np.float32), np.float32([c1, r1, c2, r2]),
                             np.asarray(RGB, np.float32))

    def get_zdim(self):
        return self.cfg["num_latents"]
