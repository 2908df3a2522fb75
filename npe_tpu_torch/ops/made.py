"""MADE (masked autoencoder for distribution estimation) + IAF (npe_tpu
`ops/made.py`; reference `layers.py:735-853`, `mask_generator.py:15-103`).

Masks are a pure, deterministic function of (seed, n_shuffles), computed on
the host with numpy at init and kept in the model's flat variables dict as
non-trainable float 0/1 tensors named `*.weights_mask`. Weight files leave
them out; `utils.checkpoints` regenerates them from the ordering at load.
`MaskGenerator` is the port's own copy of npe_tpu's (same numpy calls in the
same order, so the masks are bit-equal for the same seed and shuffle count).

Connectivity rule (`mask_generator.py:93-94`):
    mask[i, j] = (conn_in[i] <= conn_out[j])
with conn_input = ordering + 1, conn_output = ordering, and hidden
connectivity sampled from p(v) proportional to l * v over v in
[min(prev_conn), D-1] plus a unit spike at v = min(prev_conn)
(`mask_generator.py:75-91`). The shipped models use l = 0 (`layers.py:756`),
which makes hidden connectivity deterministically min(prev_conn).
"""

import numpy as np
import torch

from npe_tpu_torch.ops.activations import relu
from npe_tpu_torch.ops.initializers import orthogonal
from npe_tpu_torch.ops.linear import dense


class MaskGenerator:
    """Deterministic, replayable mask machinery (reference
    `mask_generator.py`). Host-side numpy; masks are tiny (D x H)."""

    def __init__(self, input_size, hidden_sizes, l=0.0, seed=1234):
        self.input_size = input_size
        self.hidden_sizes = list(hidden_sizes)
        self.l = l
        self.seed = seed
        self.reset()

    def reset(self):
        self._rng = np.random.RandomState(self.seed)
        self.ordering = np.arange(self.input_size)
        self.sample_connectivity()

    def shuffle_ordering(self):
        self.ordering = self._rng.permutation(self.input_size)

    def sample_connectivity(self):
        self.conns = []
        prev = self.ordering + 1
        for h in self.hidden_sizes:
            start = int(prev.min())
            if self.l == 0:
                conn = np.full(h, start)
            else:
                vals = np.arange(start, self.input_size)
                p = self.l * vals.astype(np.float64)
                p[0] += 1.0
                p = p / p.sum()
                conn = self._rng.choice(vals, size=h, p=p)
            self.conns.append(conn)
            prev = conn

    def shuffle(self, shuffling_type):
        """MADE.shuffle semantics (reference `layers.py:831-843`)."""
        if shuffling_type in ("Once", "Ordering", "Full"):
            self.shuffle_ordering()
        if shuffling_type in ("Once", "Connectivity", "Full"):
            self.sample_connectivity()

    def masks(self):
        """Returns ([mask per masked layer...], direct_input_mask), numpy.

        Layer masks: input->h1, h_i->h_{i+1}, h_last->output.
        Direct mask: input->output (reference DIML, `layers.py:680-707`).
        """
        chain = [self.ordering + 1] + self.conns + [self.ordering]
        layer_masks = [
            (chain[i][:, None] <= chain[i + 1][None, :]).astype(np.float32)
            for i in range(len(chain) - 1)
        ]
        direct = (chain[0][:, None] <= chain[-1][None, :]).astype(np.float32)
        return layer_masks, direct


def made_masks(input_size, hidden_sizes, seed=1234, n_shuffles=1, l=0.0, ordering=None):
    """The reference's shuffle('Once') / reset('Once') protocol as a pure
    function: reset, then `n_shuffles` Full shuffles. Pass `ordering`
    explicitly to reproduce a specific trained checkpoint's permutation.
    Returns numpy arrays."""
    gen = MaskGenerator(input_size, hidden_sizes, l=l, seed=seed)
    for _ in range(n_shuffles):
        gen.shuffle("Full")
    if ordering is not None:
        gen.ordering = np.asarray(ordering)
        gen.sample_connectivity()
    return gen.masks()


def mask_names(name, n_hidden):
    """The `*.weights_mask` names of one MADE net, in `made_masks` order:
    the masked stack's layers, then the direct input->output layer."""
    layers = [f"{name}_input"] + [f"{name}_layer_{i}" for i in range(1, n_hidden)]
    return [f"{n}.weights_mask" for n in layers + [f"{name}_output_W", f"{name}_output_D"]]


def made_init(gen, name, input_size, hidden_sizes, device, seed=1234, n_shuffles=1):
    """Init MADE params + mask state. Returns a flat dict keyed with the
    reference's parameter names (`layers.py:767-803`)."""
    init = orthogonal("relu")
    sizes = [input_size] + list(hidden_sizes)
    v = {}
    for i in range(len(hidden_sizes)):
        lname = f"{name}_input" if i == 0 else f"{name}_layer_{i}"
        v[f"{lname}.W"] = init(gen, (sizes[i], sizes[i + 1]), device)
        v[f"{lname}.b"] = torch.zeros(sizes[i + 1], device=device)
    for out, nin in (("W", sizes[-1]), ("D", input_size)):
        v[f"{name}_output_{out}.W"] = init(gen, (nin, input_size), device)
        v[f"{name}_output_{out}.b"] = torch.zeros(input_size, device=device)
    layer_masks, direct = made_masks(input_size, hidden_sizes, seed, n_shuffles)
    for key, m in zip(mask_names(name, len(hidden_sizes)), layer_masks + [direct]):
        v[key] = torch.from_numpy(m).to(device)
    return v


def masked_dense(z, w, mask, b=None, nonlinearity=None):
    """MaskedLayer / DIML core op (reference `layers.py:653-707`): dense with
    a non-trainable binary weights_mask."""
    out = dense(z, w * mask.to(w.dtype), b)
    return nonlinearity(out) if nonlinearity is not None else out


def _layer(v, name, z, nonlinearity=None):
    return masked_dense(z, v[f"{name}.W"], v[f"{name}.weights_mask"], v[f"{name}.b"], nonlinearity)


def made_apply(v, name, z, n_hidden=1):
    """Forward pass (reference `layers.py:817-818` -> masked stack + DIML,
    summed). Hidden nonlinearity relu, output linear."""
    h = z
    for i in range(n_hidden):
        h = _layer(v, f"{name}_input" if i == 0 else f"{name}_layer_{i}", h, relu)
    return _layer(v, f"{name}_output_W", h) + _layer(v, f"{name}_output_D", z)


def iaf_transform(z, mu, logsigma):
    """IAFLayer (reference `layers.py:641-650`): (z - mu) / exp(logsigma)."""
    return (z - mu) / torch.exp(logsigma)
