"""Headless Neural Photo Editor engine (npe_tpu `editor/engine.py`).

One brush event is: the gradient of the patch loss with respect to z through
the decoder, the latent step z - 0.05*g*(1 + (c2 - c1)), the decode, and the
DELTA / mask / composite tail (`NPE.py:192-235`). The tail always goes
through the `edit_tail` wrapper, which launches the hand-written CUDA kernel
for GPU tensors and runs its plain version for CPU tensors. Latents and the
RECON / ERROR images stay on the device between events.

Image convention at the session boundary: CHW float32 in [-1, 1] (tanh
range), as numpy, like the model API. `*_uint8()` helpers convert for display.

With `dtype=torch.bfloat16` the decode and its gradient run in bf16, as in
npe_tpu: the weights are cast once, z is cast at the model's boundary and the
decoded image widened to float32 there, so Z, RECON, DELTA, the masks, the
composite and `edit_tail` stay float32.
"""

import numpy as np
import torch

from npe_tpu_torch.api import decode_options, soft_patch_mask
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels.edit_tail import edit_tail
from npe_tpu_torch.utils import checkpoints
from npe_tpu_torch.utils.cast import cast_floating, resolve_dtype
from npe_tpu_torch.utils.device import resolve_device
from npe_tpu_torch.utils.ranges import from_tanh, to_tanh

# Gradient-descent step size for brush strokes (`NPE.py:199`).
PAINT_WEIGHT = 0.05
# Scroll (lighten/darken) step size (`NPE.py:309`).
SCROLL_WEIGHT = 0.1
# Mask blur sigma (`NPE.py:224`).
MASK_SIGMA = 0.7
# Per-stroke user-mask accumulation rate (`NPE.py:221`, commented out there).
USER_MASK_RATE = 0.05


def _soft_box_profile(shape, x1, y1, x2, y2, sigma):
    """Host-side (numpy) twin of api.soft_patch_mask for USER_MASK
    accumulation: hard box when sigma == 0, `gk`-feathered otherwise."""
    h, w = shape
    prof = np.zeros(shape, np.float32)
    prof[y1:y2, x1:x2] = 1.0
    if sigma > 0:
        cols = np.arange(w, dtype=np.float32)[None, :]
        rows = np.arange(h, dtype=np.float32)[:, None]
        dx = np.maximum(np.maximum(x1 - cols, cols - (x2 - 1)), 0.0)
        dy = np.maximum(np.maximum(y1 - rows, rows - (y2 - 1)), 0.0)
        prof = np.exp(-(dx**2 + dy**2) / (2.0 * sigma**2 * h)).astype(np.float32)
    return prof


def _chw(t):
    """(H, W, 3) tensor -> a CHW numpy array of its own (never a view of
    session state)."""
    return t.permute(2, 0, 1).contiguous().cpu().numpy()


class EditSession:
    def __init__(
        self,
        config="IAN_simple",
        variables=None,
        weights_path=None,
        dim=(10, 10),
        seed=42,
        device="cuda",
        head_mode=None,
        mdblock_mode=None,
        dtype=None,
    ):
        """variables: port variables on `device` (see
        `utils.checkpoints.from_reference`); drawn from torch.Generator(seed)
        when None. head_mode: for a model with the RGB-Beta head, the form
        every decode of this session takes (`models.common.HEAD_MODES`);
        mdblock_mode: for a model with MDBLOCKs, theirs
        (`models.common.MDBLOCK_MODES`). None leaves the model's default.
        dtype: torch.bfloat16 (or "bfloat16") runs the decode and gradient in
        bf16, the weights drawn or loaded in float32 and cast once; None or
        float32 runs in float32; any other dtype raises ValueError."""
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.module = get_config(config)
        self.decode_options = decode_options(head_mode, mdblock_mode)
        if variables is None:
            variables = self.module.init(torch.Generator().manual_seed(seed), self.device)
        if weights_path is not None:
            checkpoints.load_weights(weights_path, variables)
        if dtype is not None:
            variables = cast_floating(variables, self.dtype)
        self.variables = variables
        self.dim = tuple(dim)
        zdim = self.module.cfg["num_latents"]
        if self.dim[0] * self.dim[1] != zdim:
            raise ValueError(f"latent grid {self.dim} does not hold {zdim} latents")
        self._init_state()

    def _init_state(self):
        h, w = self.module.cfg["dims"]
        zdim = self.module.cfg["num_latents"]
        self.sample_flag = False
        self.Z = torch.zeros(zdim, device=self.device)
        self._gim = np.zeros((3, h, w), np.float32)  # ground truth, CHW tanh
        self.IM = self._gim.copy()
        self._recon = torch.zeros((h, w, 3), device=self.device)
        self._error = torch.zeros((h, w, 3), device=self.device)
        self.DELTA = np.zeros((3, h, w), np.float32)
        self.USER_MASK = np.zeros((h, w), np.float32)
        # Undo stack: each edit op pushes a snapshot; undo() pops. Tensors in
        # it are never written in place, so references suffice.
        self._undo = []
        self.undo_depth = 32

    def fork(self):
        """A new session with fresh editor state that SHARES this session's
        weights; only the per-image state is new."""
        s = object.__new__(EditSession)
        for attr in ("device", "dtype", "module", "variables", "dim", "decode_options"):
            setattr(s, attr, getattr(self, attr))
        s._init_state()
        return s

    # --- the model pieces of one event -------------------------------------

    def _decode_hwc(self, z_flat):
        """The decode of a float32 z in this session's dtype, as a float32
        (H, W, 3) image."""
        xh = self.module.decode(self.variables, z_flat[None].to(self.dtype), **self.decode_options)
        return xh[0].permute(1, 2, 0).float().contiguous()

    def _patch_grad(self, z, c1, r1, c2, r2, sigma, rgb_hwc=None):
        """d(patch loss)/dz through the decoder: the mean squared distance to
        rgb_hwc over the (feathered) box, or with rgb_hwc None the mean
        brightness there."""
        z = z.detach().requires_grad_(True)
        xh = self._decode_hwc(z)
        m = soft_patch_mask(xh.shape[0], xh.shape[1], c1, r1, c2, r2, sigma, xh.dtype, self.device)
        num = xh if rgb_hwc is None else (rgb_hwc - xh) ** 2
        loss = (num * m[:, :, None]).sum() / (m.sum() * xh.shape[2])
        (g,) = torch.autograd.grad(loss, z)
        return g

    def _composite(self, xh):
        """The shown image: the composite tail, or on the sample path
        (`sample_flag`) the raw decode."""
        if self.sample_flag:
            return xh
        um = torch.from_numpy(self.USER_MASK).to(self.device)
        return edit_tail(xh, self._recon, self._error, um, MASK_SIGMA)

    # --- helpers ------------------------------------------------------------

    @property
    def GIM(self):
        return self._gim

    @property
    def RECON(self):
        return _chw(self._recon)

    @property
    def ERROR(self):
        return _chw(self._error)

    @property
    def Z_grid(self):
        return np.array(self.Z.cpu()).reshape(self.dim)

    def im_uint8(self):
        return np.uint8(np.clip(from_tanh(self.IM), 0, 255))

    def _quantized(self, xh_hwc):
        """Reference RECON passes through uint8 (`NPE.py:261`): quantize to
        the uint8 grid but stay in tanh units."""
        q = to_tanh(np.float32(np.uint8(np.clip(from_tanh(xh_hwc.cpu().numpy()), 0, 255))))
        return torch.from_numpy(q).to(self.device)

    # --- undo ----------------------------------------------------------------

    def _snapshot(self):
        self._undo.append(
            (
                self.Z,
                self.IM.copy(),
                self._recon,
                self._error,
                self.DELTA.copy(),
                self.USER_MASK.copy(),
                self.sample_flag,
            )
        )
        if len(self._undo) > self.undo_depth:
            self._undo.pop(0)

    def undo(self):
        """Revert the most recent edit operation (stroke/scroll/latent-paint/
        sample). Returns the restored image, or None if nothing to undo."""
        if not self._undo:
            return None
        (self.Z, self.IM, self._recon, self._error, self.DELTA,
         self.USER_MASK, self.sample_flag) = self._undo.pop()
        return self.IM

    @property
    def can_undo(self):
        return bool(self._undo)

    # --- operations (reference `NPE.py` callbacks) ---------------------------

    @torch.no_grad()
    def infer(self, image_chw_tanh):
        """Load a ground-truth image, encode, reconstruct (`NPE.py:239-274`)."""
        self._gim = np.float32(image_chw_tanh)
        self.IM = self._gim.copy()
        x = torch.from_numpy(self._gim).to(self.device)
        self.Z = self.module.encode(self.variables, x[None].to(self.dtype))[0].float()
        self._recon = self._quantized(self._decode_hwc(self.Z))
        self._error = (x.permute(1, 2, 0) - self._recon).contiguous()
        self.DELTA = np.zeros_like(self._gim)
        self.USER_MASK = np.zeros_like(self.USER_MASK)
        self.sample_flag = False
        self._undo.clear()
        return self.IM

    def reset(self):
        """Re-encode the ground truth (`NPE.py:330-340`)."""
        return self.infer(self._gim)

    def update_gim(self):
        """Promote the current image to ground truth (`NPE.py:342-345`)."""
        self._gim = np.float32(self.IM)
        return self.reset()

    @torch.no_grad()
    def sample(self, gen_or_seed=0):
        """Z ~ N(0,1) from a torch.Generator (or a seed for a new CPU one),
        decode (`NPE.py:317-327`)."""
        gen = (
            torch.Generator().manual_seed(gen_or_seed)
            if isinstance(gen_or_seed, int)
            else gen_or_seed
        )
        self._snapshot()
        self.Z = torch.randn(self.Z.shape, generator=gen, device=gen.device).to(self.device)
        xh = self._decode_hwc(self.Z)
        self._recon = self._quantized(xh)
        self._error = (torch.from_numpy(self.IM).to(self.device).permute(1, 2, 0) - self._recon).contiguous()
        self.sample_flag = True
        self.IM = _chw(xh)
        return self.IM

    def paint_stroke(self, x1, y1, x2, y2, rgb, sigma=0.0):
        """One brush event (`NPE.py:192-235`). rgb: length-3 iterable in
        [0, 255]. The box is [y1, y2) rows x [x1, x2) cols in 64-space.
        sigma>0 = soft brush: the patch loss is feathered by the reference's
        `gk` Gaussian localizer (`NPE.py:167-175`)."""
        rgb_hwc = torch.as_tensor(to_tanh(np.float32(rgb)), device=self.device).expand(
            self._recon.shape
        )
        self._snapshot()
        # Accumulate the user mask under the brush (the reference's sketched
        # `USER_MASK[y1:y2,x1:x2]+=0.05`, `NPE.py:221`); soft strokes
        # accumulate the same feathered profile the loss sees.
        prof = _soft_box_profile(self.USER_MASK.shape, x1, y1, x2, y2, sigma)
        self.USER_MASK = np.minimum(self.USER_MASK + USER_MASK_RATE * prof, 1.0)
        g = self._patch_grad(self.Z, x1, y1, x2, y2, float(sigma), rgb_hwc)
        with torch.no_grad():
            z2 = self.Z - PAINT_WEIGHT * g * (1.0 + (x2 - x1))
            xh = self._decode_hwc(z2)
            im = self._composite(xh)
            self.Z = z2
            self.IM = _chw(im)
            self.DELTA = _chw(xh - self._recon)
        return self.IM

    def scroll_patch(self, x1, y1, x2, y2, direction, sigma=0.0):
        """Mouse-wheel lighten/darken (`NPE.py:305-314`)."""
        self._snapshot()
        g = self._patch_grad(self.Z, x1, y1, x2, y2, float(sigma))
        with torch.no_grad():
            self.Z = self.Z + float(np.sign(direction)) * SCROLL_WEIGHT * g * (1.0 + (x2 - x1))
            self.IM = _chw(self._decode_hwc(self.Z))
        return self.IM

    @torch.no_grad()
    def set_latents(self, z_grid):
        """Direct latent painting (`NPE.py:277-302`): caller supplies the
        pooled latent grid; we re-composite."""
        self._snapshot()
        self.Z = torch.from_numpy(np.float32(z_grid).reshape(-1)).to(self.device)
        self.IM = _chw(self._composite(self._decode_hwc(self.Z)))
        return self.IM

    @torch.no_grad()
    def decode_current(self):
        return _chw(self._decode_hwc(self.Z))
