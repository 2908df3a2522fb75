"""Headless Neural Photo Editor engine (npe_tpu `editor/engine.py`).

One brush event is: the gradient of the patch loss with respect to z through
the decoder, the latent step z - 0.05*g*(1 + (c2 - c1)), the decode, and the
DELTA / mask / composite tail (`NPE.py:192-235`). The tail always goes
through the `edit_tail` wrapper, which launches the hand-written CUDA kernel
for GPU tensors and runs its plain version for CPU tensors. Latents and the
RECON / ERROR images stay on the device between events.

Every step runs through the session's `captured.EditRunner`: on the card
`paint_stroke`, `scroll_patch` and `set_latents` are each one replayed CUDA
graph, npe_tpu's jitted `_paint_step`, `_scroll_step` and `_composite_step`,
with one upload of the brush's values and one download of the images; the
encode and decode of `infer` (and so `reset` and `update_gim`), `sample` and
`decode_current` are two more, npe_tpu's `_encode` and `_decode_fn`, around
the host-side uint8 quantisation of RECON. On the CPU (or with `eager=True`)
the same bodies run directly.

Image convention at the session boundary: CHW float32 in [-1, 1] (tanh
range), as numpy, like the model API. `*_uint8()` helpers convert for display.

With `dtype=torch.bfloat16` the decode and its gradient run in bf16, as in
npe_tpu: the weights are cast once, z is cast at the model's boundary and the
decoded image widened to float32 there, so Z, RECON, DELTA, the masks, the
composite and `edit_tail` stay float32.
"""

import numpy as np
import torch

from npe_tpu_torch.api import decode_options
from npe_tpu_torch.editor.captured import EditRunner
from npe_tpu_torch.models import get_config
from npe_tpu_torch.utils import checkpoints
from npe_tpu_torch.utils.cast import cast_floating, resolve_dtype
from npe_tpu_torch.utils.device import resolve_device
from npe_tpu_torch.utils.profiling import annotate
from npe_tpu_torch.utils.ranges import from_tanh, to_tanh

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
        eager=False,
    ):
        """variables: port variables on `device` (see
        `utils.checkpoints.from_reference`); drawn from torch.Generator(seed)
        when None. head_mode: for a model with the RGB-Beta head, the form
        every decode of this session takes (`models.common.HEAD_MODES`);
        mdblock_mode: for a model with MDBLOCKs, theirs
        (`models.common.MDBLOCK_MODES`). None leaves the model's default.
        dtype: torch.bfloat16 (or "bfloat16") runs the decode and gradient in
        bf16, the weights drawn or loaded in float32 and cast once; None or
        float32 runs in float32; any other dtype raises ValueError.
        eager: on the card, run the edit steps' bodies without CUDA graphs
        (for comparisons and timings; the CPU never has graphs)."""
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
        self.runner = EditRunner(self.module, self.variables, self.dtype, self.decode_options, self.device, eager)
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
        weights and its runner (its captured programs); only the per-image
        state is new."""
        s = object.__new__(EditSession)
        for attr in ("device", "dtype", "module", "variables", "dim", "decode_options", "runner"):
            setattr(s, attr, getattr(self, attr))
        s._init_state()
        return s

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

    def _set_recon(self, xh_chw, target_chw):
        """RECON from a decode, ERROR = target - RECON (HWC on the device).
        Reference RECON passes through uint8 (`NPE.py:261`): quantize to the
        uint8 grid but stay in tanh units."""
        q = to_tanh(np.float32(np.uint8(np.clip(from_tanh(xh_chw.transpose(1, 2, 0)), 0, 255))))
        self._recon = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        self._error = torch.from_numpy(np.ascontiguousarray(target_chw.transpose(1, 2, 0) - q)).to(self.device)

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

    def infer(self, image_chw_tanh):
        """Load a ground-truth image, encode, reconstruct (`NPE.py:239-274`)."""
        self._gim = np.float32(image_chw_tanh)
        self.IM = self._gim.copy()
        self.Z = self.runner.encode(self._gim)
        self._set_recon(self.runner.decode(self.Z), self._gim)
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
        xh = self.runner.decode(self.Z)
        self._set_recon(xh, self.IM)
        self.sample_flag = True
        self.IM = xh
        return self.IM

    def paint_stroke(self, x1, y1, x2, y2, rgb, sigma=0.0):
        """One brush event (`NPE.py:192-235`). rgb: length-3 iterable in
        [0, 255]. The box is [y1, y2) rows x [x1, x2) cols in 64-space.
        sigma>0 = soft brush: the patch loss is feathered by the reference's
        `gk` Gaussian localizer (`NPE.py:167-175`)."""
        with annotate("npe.paint_stroke"):
            rgb_tanh = to_tanh(np.float32(rgb))
            if rgb_tanh.shape != (3,):
                raise ValueError(f"rgb must hold 3 values, got {np.shape(rgb)}")
            self._snapshot()
            # Accumulate the user mask under the brush (the reference's sketched
            # `USER_MASK[y1:y2,x1:x2]+=0.05`, `NPE.py:221`); soft strokes
            # accumulate the same feathered profile the loss sees.
            prof = _soft_box_profile(self.USER_MASK.shape, x1, y1, x2, y2, sigma)
            self.USER_MASK = np.minimum(self.USER_MASK + USER_MASK_RATE * prof, 1.0)
            self.Z, self.IM, self.DELTA = self.runner.paint(
                self.Z, self._recon, self._error, self.USER_MASK, (x1, y1, x2, y2), float(sigma), rgb_tanh,
                not self.sample_flag)
        return self.IM

    def scroll_patch(self, x1, y1, x2, y2, direction, sigma=0.0):
        """Mouse-wheel lighten/darken (`NPE.py:305-314`)."""
        self._snapshot()
        self.Z, self.IM = self.runner.scroll(self.Z, (x1, y1, x2, y2), float(sigma), float(np.sign(direction)))
        return self.IM

    def set_latents(self, z_grid):
        """Direct latent painting (`NPE.py:277-302`): caller supplies the
        pooled latent grid; we re-composite."""
        z = np.float32(z_grid).reshape(-1)
        if z.shape != tuple(self.Z.shape):
            raise ValueError(f"z_grid holds {z.size} latents, the model {self.Z.numel()}")
        self._snapshot()
        self.Z = torch.from_numpy(z).to(self.device)
        self.IM = self.runner.composite(self.Z, self._recon, self._error, self.USER_MASK, not self.sample_flag)
        return self.IM

    def decode_current(self):
        return self.runner.decode(self.Z)
