"""The editor's steps as captured programs: the counterpart of npe_tpu's
jitted `_paint_step`, `_scroll_step`, `_composite_step`, `_encode` and
`_decode_fn` (`npe_tpu/editor/engine.py`). On the card each step is one CUDA
graph (`utils/graphs.Program`), replayed for every brush event, load and
sample; the brush box, `sigma`, the colour, the composite flag and the
scroll direction are values in device buffers, so moving or resizing the
brush never re-captures.

An `EditRunner` belongs to one module, one set of variables, one dtype, one
set of `decode_options` and one device; `EditSession` makes one and its forks
share it, as npe_tpu's forks share their compiled programs. It holds static
buffers: z (float32), RECON, ERROR, and `inputs`, which holds USER_MASK, the
box c1, r1, c2, r2, `sigma`, the composite flag (`composite_on`), the scroll
direction and the rgb target (tanh units); `image`, a CHW image to encode;
and `out`, the new z, IM (CHW) and DELTA (CHW) packed. Each body computes what
npe_tpu's function of the same name computes, from the buffers:

* paint: the gradient of the patch loss with respect to z through the
  decoder, z - 0.05 g (1 + (c2 - c1)), the decode, and
  `torch.where(composite_on, edit_tail(...), xh)`, so `edit_tail` runs on
  every paint step whatever the flag, as in npe_tpu;
* scroll: the gradient of the patch's mean brightness, z + direction 0.1 g
  (1 + (c2 - c1)), the decode;
* composite: the decode of z and the same `torch.where` tail;
* encode: the latents of `image` (`infer`, `reset`, `update_gim`);
* decode: the decode of z (`infer`, `sample`, `decode_current`); the session
  quantises RECON to uint8 on the host from it, as npe_tpu does.

A call, whatever its kind: the host's values go into one pinned staging
tensor and reach `inputs` in one copy; z, RECON and ERROR come in by
device-to-device copies from the calling session's own tensors (forks share
the runner, so each call copies its caller's state in); the program runs; the
new z is cloned into a tensor of the caller's own (a replay overwrites
`out`, and the session's undo stack keeps references); the images come back
in one device-to-host copy and one synchronise. A lock makes a call atomic,
so sessions on several threads may share a runner. Under a profiler the
call's spans (`utils/profiling.py`) are `npe.stage` (the values staged and
uploaded, the caller's tensors copied in), the program's, `npe.wait` (the
synchronise) and `npe.unpack` (the images copied into arrays of their own).

The traps, and what is done about each:

* Python values baked into a graph. Nothing the host chooses per call is a
  Python value in a body: the box, `sigma`, the step factor, the flag and the
  direction are read from `inputs` (`api.soft_patch_mask` takes 0-d device
  tensors and reads nothing from the host), and the uploads are outside the
  bodies.
* Host calls at a kernel's first launch (`cudaFuncSetAttribute` for dynamic
  shared memory, the bf16 MDBLOCK's tensor-map encoder, `edit_tail`'s cached
  taps) happen in a kind's first call, which runs eagerly and gives the
  result; the capture follows it (a pure `Program`). The pointers baked into a graph are its pool's, the buffers'
  and the weights', which stay where they are.
* Autograd inside the graph. The gradient runs under
  `torch.inference_mode(False)` and `torch.enable_grad()`, whatever the
  caller's mode, with z a leaf that requires it; its backward ops run on the
  capture stream, as their forward ops do.
* The capture mode is "thread_local" (`Program`'s): a capture refuses the
  unsafe CUDA calls of its own thread only. The web editor serves every request on a new
  thread (`ThreadingHTTPServer`), and a process may also run a serving
  dispatcher; under the default "global" mode a call such as cudaMalloc or a
  synchronise on any of those threads would invalidate a capture that is
  under way on another.
* Launch counters: see `utils/graphs.py`; the first call counts its eager
  launches, every replay adds those of one step.
* Failure raises: a capture or a replay that fails raises, and nothing falls
  back to eager steps or to the CPU.

On the CPU, or with `eager=True` on the card, each call runs the same bodies
on the same buffers directly. The five graphs share one memory pool: they
never run at once, and every tensor they allocate dies inside its step.
"""

import threading
import weakref

import numpy as np
import torch

from npe_tpu_torch.api import soft_patch_mask
from npe_tpu_torch.ops.kernels.edit_tail import edit_tail
from npe_tpu_torch.utils.graphs import Program
from npe_tpu_torch.utils.profiling import annotate

# Gradient-descent step size for brush strokes (`NPE.py:199`).
PAINT_WEIGHT = 0.05
# Scroll (lighten/darken) step size (`NPE.py:309`).
SCROLL_WEIGHT = 0.1
# Mask blur sigma (`NPE.py:224`).
MASK_SIGMA = 0.7
# The scalars of `inputs`, in order, after USER_MASK.
SCALARS = ("c1", "r1", "c2", "r2", "sigma", "composite_on", "direction")
KINDS = ("paint", "scroll", "composite", "encode", "decode")


class EditRunner:
    """The editor's three steps for `module` with `variables` in `dtype`
    under `decode_options`, over static buffers on `device` (the module
    docstring has the rules). `eager=True` runs the bodies without graphs on
    the card too. `programs` maps each kind to its `Program`."""

    def __init__(self, module, variables, dtype, decode_options, device, eager=False):
        self.module, self.variables, self.dtype, self.decode_options = module, variables, dtype, decode_options
        self.device = torch.device(device)
        (self.h, self.w), self.zdim = module.cfg["dims"], module.cfg["num_latents"]
        hw = self.h * self.w
        cuda = self.device.type == "cuda"
        # USER_MASK first: edit_tail reads it as 16-byte aligned rows
        n_in = hw + len(SCALARS) + 3
        self.staging = torch.empty(n_in, dtype=torch.float32, pin_memory=cuda)
        self._staged = self.staging.numpy()
        self.inputs = torch.empty(n_in, dtype=torch.float32, device=self.device)
        self.user_mask = self.inputs[:hw].view(self.h, self.w)
        for name, t in zip(SCALARS, self.inputs[hw:hw + len(SCALARS)].unbind()):
            setattr(self, name, t)
        self.rgb = self.inputs[hw + len(SCALARS):]
        self.image = torch.empty((3, self.h, self.w), device=self.device)
        self.image_staging = torch.empty((3, self.h, self.w), dtype=torch.float32, pin_memory=cuda)
        self.image_uploaded = torch.cuda.Event() if cuda else None
        self.z = torch.empty(self.zdim, device=self.device)
        self.recon = torch.empty((self.h, self.w, 3), device=self.device)
        self.error = torch.empty_like(self.recon)
        n_out = self.zdim + 2 * 3 * hw
        self.out = torch.empty(n_out, device=self.device)
        self.out_host = torch.empty(n_out, dtype=torch.float32, pin_memory=cuda)
        self._returned = self.out_host.numpy()
        self.lock = threading.Lock()
        stream = torch.cuda.Stream(self.device) if cuda and not eager else None
        pool = torch.cuda.graph_pool_handle() if stream is not None else None
        # the bodies reach the runner by a weak reference: no reference cycle,
        # so a runner that is dropped frees its graphs at once, never in a
        # later collection that could fall inside another capture
        me = weakref.ref(self)
        bodies = {"paint": lambda: me()._paint(), "scroll": lambda: me()._scroll(),
                  "composite": lambda: me()._composite(), "encode": lambda: me()._encode(),
                  "decode": lambda: me()._decode()}
        self.programs = {kind: Program(bodies[kind], stream, pool, pure=True) for kind in KINDS}

    # --- the bodies (fixed tensors in, `out` written) -------------------------

    def decode_hwc(self, z_flat):
        """The decode of a float32 z in this runner's dtype, as a float32
        (H, W, 3) image."""
        xh = self.module.decode(self.variables, z_flat[None].to(self.dtype), **self.decode_options)
        return xh[0].permute(1, 2, 0).float().contiguous()

    def _patch_grad(self, rgb=None):
        """d(patch loss)/dz through the decoder at the buffer z: the mean
        squared distance to `rgb` over the (feathered) box, or with rgb None
        the mean brightness there."""
        with torch.inference_mode(False), torch.enable_grad():
            z = self.z.detach().requires_grad_(True)
            xh = self.decode_hwc(z)
            m = soft_patch_mask(self.h, self.w, self.c1, self.r1, self.c2, self.r2, self.sigma, xh.dtype,
                                self.device)
            num = xh if rgb is None else (rgb - xh) ** 2
            loss = (num * m[:, :, None]).sum() / (m.sum() * xh.shape[2])
            (g,) = torch.autograd.grad(loss, z)
        return g

    def _shown(self, xh):
        """The composite tail, or where the flag is off the raw decode."""
        tail = edit_tail(xh, self.recon, self.error, self.user_mask, MASK_SIGMA)
        return torch.where(self.composite_on != 0, tail, xh)

    def _write(self, *parts):
        """z, then HWC images as CHW, packed at the start of `out`."""
        flat = [parts[0]] + [p.permute(2, 0, 1).reshape(-1) for p in parts[1:]]
        torch.cat(flat, out=self.out[:sum(f.numel() for f in flat)])

    def _paint(self):
        g = self._patch_grad(self.rgb)
        with torch.no_grad():
            z2 = self.z - PAINT_WEIGHT * g * (1.0 + (self.c2 - self.c1))
            xh = self.decode_hwc(z2)
            self._write(z2, self._shown(xh), xh - self.recon)

    def _scroll(self):
        g = self._patch_grad()
        with torch.no_grad():
            z2 = self.z + self.direction * SCROLL_WEIGHT * g * (1.0 + (self.c2 - self.c1))
            self._write(z2, self.decode_hwc(z2))

    def _composite(self):
        with torch.no_grad():
            self._write(self.z, self._shown(self.decode_hwc(self.z)))

    def _encode(self):
        with torch.no_grad():
            self._write(self.module.encode(self.variables, self.image[None].to(self.dtype))[0].float())

    def _decode(self):
        with torch.no_grad():
            self._write(self.z, self.decode_hwc(self.z))

    # --- calls --------------------------------------------------------------

    def _call(self, kind, images, z, recon=None, error=None, user_mask=None, box=(0, 0, 0, 0), sigma=0.0,
              composite=False, direction=0.0, rgb=(0.0, 0.0, 0.0)):
        """Stage the host's values, copy the caller's tensors in, run `kind`'s
        program, and return (the new z as a tensor of the caller's own, the
        first `images` CHW images of `out` as numpy arrays of their own)."""
        hw = self.h * self.w
        with self.lock:
            with annotate("npe.stage"):
                if kind != "decode":  # the one kind that reads none of `inputs`
                    staged = self._staged
                    if user_mask is not None:
                        staged[:hw] = np.asarray(user_mask, np.float32).reshape(hw)
                    staged[hw:hw + len(SCALARS)] = (*box, sigma, float(composite), direction)
                    staged[hw + len(SCALARS):] = rgb
                    self.inputs.copy_(self.staging, non_blocking=True)
                pairs = [(d, s) for d, s in ((self.z, z), (self.recon, recon), (self.error, error)) if s is not None]
                torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])
            self.programs[kind]()
            z_new = self.out[:self.zdim].clone()
            n = self.zdim + images * 3 * hw
            self.out_host[self.zdim:n].copy_(self.out[self.zdim:n], non_blocking=True)
            if self.device.type == "cuda":
                with annotate("npe.wait"):
                    torch.cuda.current_stream(self.device).synchronize()
            with annotate("npe.unpack"):
                shown = [self._returned[self.zdim + i * 3 * hw:self.zdim + (i + 1) * 3 * hw]
                         .reshape(3, self.h, self.w).copy() for i in range(images)]
        return z_new, shown

    def paint(self, z, recon, error, user_mask, box, sigma, rgb, composite):
        """One stroke: (the new z, IM, DELTA). box (c1, r1, c2, r2) in
        pixels; rgb the target in tanh units; composite False shows the raw
        decode (the sample path)."""
        z_new, (im, delta) = self._call("paint", 2, z, recon, error, user_mask, box, sigma, composite, rgb=rgb)
        return z_new, im, delta

    def scroll(self, z, box, sigma, direction):
        """One lighten (direction +1) or darken (-1) step: (the new z, IM)."""
        z_new, (im,) = self._call("scroll", 1, z, box=box, sigma=sigma, direction=direction)
        return z_new, im

    def composite(self, z, recon, error, user_mask, composite):
        """The shown image of z: IM."""
        return self._call("composite", 1, z, recon, error, user_mask, composite=composite)[1][0]

    def encode(self, image):
        """The latents of a CHW image in tanh units, as a float32 tensor of
        the caller's own."""
        with self.lock:
            if self.image_uploaded is not None:
                self.image_uploaded.synchronize()  # the last upload has left the staging buffer
            self.image_staging.numpy()[...] = image
            self.image.copy_(self.image_staging, non_blocking=True)
            if self.image_uploaded is not None:
                self.image_uploaded.record()
            self.programs["encode"]()
            return self.out[:self.zdim].clone()

    def decode(self, z):
        """The decode of z: a CHW float32 numpy array of its own."""
        return self._call("decode", 1, z)[1][0]
