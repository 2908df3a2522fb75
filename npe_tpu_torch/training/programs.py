"""The sampling and evaluation programs of training as captured programs:
the counterpart of npe_tpu's `jax.jit(lambda v, x: ...)` closures in
`training/sample.py` (the four inference functions), `eval_grids.py` (the
grid's decode and encode), `evaluate.py` (`recon_mse`) and `quality.py`
(`feats` and `gen`).

An `EvalPrograms` belongs to one module and one device. Weights are an input
of npe_tpu's programs, not constants, and so they are here: static buffers,
made by the first `load` in its structure and shapes, float32 (npe_tpu's
trainer evaluates its float32 masters), into which every `load` copies a
variables dict with one `torch._foreach_copy_`. A program reads the buffers
when it runs, so it computes with the weights loaded last, whatever tensors
they came from: nothing is keyed on a tensor's identity, and the trainer
updates its state in place. Loading, not the tensors a caller holds, is what
a program sees.

Its programs (`PROGRAMS`) are those of a `utils/graphs.ProgramCache`, one
per function and input shape, as npe_tpu's `jax.jit` keeps one per shape:
on the card each a CUDA graph, captured after the eager first call of its
shape and replayed at every later call; on the CPU, or with `eager=True`,
the same bodies run directly on the same buffers. A capture or a replay that
fails raises; nothing falls back to eager calls. The cache holds the bodies
by weak references, so an owner forms no reference cycle and its graphs go
with it.
"""

import torch

from npe_tpu_torch.ops.conv import global_avg_pool
from npe_tpu_torch.utils.graphs import ProgramCache

# decode_pre_iaf, decode, encode_pre_iaf, iaf (its first output) and features
# (GlobalPool(enc_conv4), the encoder-FID's feature space) of a batch;
# recon_mse, the mean of (decode(encode(x)) - x)^2 over a batch, 0-d
PROGRAMS = ("decode_pre_iaf", "decode", "encode_pre_iaf", "iaf", "recon_mse", "features")


def device_of(variables):
    return next(iter(variables.values())).device


def sample_program(module):
    """The model's sample path: the pre-IAF decode for IAF models, as the
    trainer feeds Z (reference `train_IAN.py:479`)."""
    return "decode_pre_iaf" if getattr(module, "HAS_IAF", False) else "decode"


class EvalPrograms:
    """`module`'s sampling and evaluation programs on `device` over the
    weights loaded last (the module docstring has the rules). `eager`: on the
    card, run the bodies without CUDA graphs (for comparisons and timings;
    the CPU never has graphs)."""

    def __init__(self, module, device, eager=False):
        self.module = module
        self.programs = ProgramCache(device, eager)
        self.device = self.programs.device
        self.variables = None
        for name in PROGRAMS:
            self.programs.define(name, getattr(self, "_" + name))

    @classmethod
    def of(cls, module, variables, eager=False):
        """An owner on the device of `variables`, holding them."""
        owner = cls(module, device_of(variables), eager)
        owner.load(variables)
        return owner

    def load(self, variables):
        """Copy `variables`, a dict of float32 tensors on this owner's device,
        into the buffers, which the first load makes. Raises ValueError on
        another structure, shape, dtype or device than the buffers'."""
        for k, v in variables.items():
            if v.dtype != torch.float32 or v.device != self.device:
                raise ValueError(f"variable {k}: {v.dtype} on {v.device}, the programs take float32 on {self.device}")
        if self.variables is None:
            with torch.inference_mode(False):  # buffers that calls in any grad mode may write
                self.variables = {k: torch.empty_like(v) for k, v in variables.items()}
        if sorted(variables) != sorted(self.variables):
            raise ValueError("the variables' structure is not the one these programs were loaded with")
        for k, v in variables.items():
            if v.shape != self.variables[k].shape:
                raise ValueError(f"variable {k}: {tuple(v.shape)}, the programs' is {tuple(self.variables[k].shape)}")
        with torch.no_grad():
            torch._foreach_copy_([self.variables[k] for k in variables], list(variables.values()))

    def __call__(self, name, *args, download=False):
        """Run program `name` on args (tensors, or host arrays): the outputs
        as new tensors on this owner's device, or, with `download`, as numpy
        arrays (`ProgramCache`'s call)."""
        if self.variables is None:
            raise RuntimeError("no weights loaded: call load(variables) first")
        return self.programs(name, *args, download=download)

    # --- the bodies (tensors on the device in, tensors out) -----------------------

    @torch.no_grad()
    def _decode_pre_iaf(self, z):
        return self.module.decode_pre_iaf(self.variables, z)

    @torch.no_grad()
    def _decode(self, z):
        return self.module.decode(self.variables, z)

    @torch.no_grad()
    def _encode_pre_iaf(self, x):
        return self.module.encode_pre_iaf(self.variables, x)

    @torch.no_grad()
    def _iaf(self, z):
        return self.module.iaf(self.variables, z)[0]

    @torch.no_grad()
    def _recon_mse(self, x):
        x_hat = self.module.decode(self.variables, self.module.encode(self.variables, x))
        return torch.mean((x_hat - x) ** 2)

    @torch.no_grad()
    def _features(self, x):
        return global_avg_pool(self.module.backbone(self.variables, x, False, None)[-1])
