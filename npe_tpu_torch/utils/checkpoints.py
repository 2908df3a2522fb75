"""Checkpointing, on `npe_tpu`'s file ABI (`npe_tpu/utils/checkpoints.py`).

A weight file is a name-keyed .npz of arrays in `npe_tpu`'s layouts (conv
kernels HWIO, deconv kernels (kh, kw, cin, cout), dense rows in NHWC-flatten
order) plus a pickled metadata dict, written atomically through a unique
temp file. MADE masks (`*.weights_mask`) are left out of the file unless
asked for: each MADE net's ordering rides in the metadata
(`made_orderings`) and the masks are regenerated from it at load. Restore is name-matched; a shape mismatch or a missing name warns
and skips, and a file newer than `FORMAT_VERSION` is refused. Files written
by `npe_tpu` load here and files written here load into `npe_tpu`.

Layouts change only at this boundary: `from_reference` turns `npe_tpu`'s
arrays into the port's tensors and `to_reference` is its exact inverse.

`save_train_state` / `load_train_state` persist the whole train state
(variables, Adam moments and counts, step) in a file of the port's own: an
.npz of NAMED leaves (`parts/gen/dec_out.W`, `opt/gen/mu/dec_out.W`,
`opt/gen/count`, `step`) in `npe_tpu`'s layouts, plus the pickled metadata.
`npe_tpu`'s own train-state file keeps its leaf order in a pickled jax
treedef, which cannot be read without jax; `train_state_from_reference` /
`train_state_to_reference` carry a state across in memory instead.
"""

import concurrent.futures
import logging
import os
import pickle
import threading
import uuid

import numpy as np
import torch

from npe_tpu_torch.ops.made import made_masks, mask_names

logger = logging.getLogger(__name__)

METADATA_KEY = "__metadata__"
# Same history as npe_tpu: v0 unversioned, v1 adds the stamp; same arrays.
FORMAT_VERSION = 1

MASK_SUFFIX = ".weights_mask"
DIRECT_MASK_SUFFIX = "_output_D" + MASK_SUFFIX


def is_deconv(name):
    """Deconv kernels are the `.W` of the decoder's layers (`dec_*.W`,
    npe_tpu's `VarBuilder.deconv`). Every other 4-D weight is a conv kernel,
    the MDCL filters among them, whose names end in a bare `W` (`RW`, `G_aW`,
    and full IAN's `dec_conv2aW`)."""
    return name.startswith("dec_") and name.endswith(".W")


def _to_port_layout(name, arr):
    """One npe_tpu array -> the port's layout (numpy in, numpy out)."""
    if arr.ndim != 4:
        return arr
    # conv (kh, kw, cin, cout) -> (cout, cin, kh, kw);
    # deconv (kh, kw, cin, cout) -> (cin, cout, kh, kw)
    return arr.transpose(2, 3, 0, 1) if is_deconv(name) else arr.transpose(3, 2, 0, 1)


def _to_reference_layout(name, arr):
    if arr.ndim != 4:
        return arr
    return arr.transpose(2, 3, 0, 1) if is_deconv(name) else arr.transpose(2, 3, 1, 0)


def from_reference(variables, device):
    """npe_tpu variables (name -> array) -> port variables (name -> tensor
    on `device`). Dense weights keep their rows: the port's `dense` flattens
    NCHW maps in npe_tpu's (H, W, C) order."""
    return {
        k: torch.from_numpy(np.array(_to_port_layout(k, np.asarray(v)), order="C")).to(device)
        for k, v in variables.items()
    }


def to_reference(variables):
    """Port variables -> npe_tpu variables (name -> numpy array); the exact
    inverse of `from_reference`."""
    return {
        k: np.ascontiguousarray(_to_reference_layout(k, v.detach().cpu().numpy()))
        for k, v in variables.items()
    }


def mdcl_fan_taps(variables, name):
    """How many taps' worth of variance per input channel a pre-activation
    of MDCL `name`'s composed kernel sees, from its coefficients (their means
    over the output channels): the centre tap carries the filter's own centre
    times (base + every dilated scale's coefficient, which all land there)
    plus a ninth of the scale-0 coefficient times each of the nine taps; each
    of the eight other taps of a 3x3 branch carries that branch's coefficient.
    Squared and summed. The RGB-Beta head as initialized (scales [2, 3, 4],
    every coefficient 1/4) gives 1 + 32/16 = 3; an MDBLOCK's [0, 2] at 1/3
    gives 2.28 and its [0, 2, 3] at 1/4 gives 2.11."""
    prefix = f"{name}_coeff_"
    coeffs = {k[len(prefix):]: float(np.mean(np.asarray(v))) for k, v in variables.items()
              if k.startswith(prefix)}
    mean_branch = coeffs.pop("1x1", 0.0) / 9.0
    centre = sum(coeffs.values()) + mean_branch
    return centre**2 + 8 * mean_branch**2 + 8 * sum(c**2 for c in coeffs.values())


def unit_gain(variables, mdcl_taps=None, iaf_logsigma_gain=1.0):
    """Seeded weights for comparisons, not for training: npe_tpu variables (name -> array) with each weight kernel rescaled to
    a He-style std sqrt(2 / fan_in), as numpy float32; names, shapes and all
    other arrays unchanged. Both packages' inits draw kernels from
    Normal(0.02), under which activations shrink layer by layer until any two
    implementations agree within atol 1e-4 whatever they compute; at unit
    gain they stay O(1), so comparisons of two devices or two packages on
    seeded weights mean something.

    MDCL filters (4-D, names ending in a bare `W`) take the fan
    `mdcl_taps * cin`, by default `mdcl_fan_taps` of the filter's own scale
    set and coefficients. The two filters of an MDBLOCK (a `{name}bnorm0`
    stands beside them) sit on a residual branch, y = x + MDCL2(..MDCL1(..x)):
    at He's gain the sum would double the variance in every block, so they
    take std sqrt(1 / fan) and a block adds about a quarter to it. MADE
    weights (2-D, beside a
    `.weights_mask`) are left as drawn, their orthogonal init at gain sqrt(2)
    being unit gain already, except that the IAF log-sigma net's output
    layers (`*_ls_output_*.W`) are multiplied by `iaf_logsigma_gain`: a
    caller that passes 0.1 keeps exp(logsigma) near 1, so that the flow does
    not throw latents far outside the decoder's range. Masks, biases, BN
    state and MDCL coefficients pass unchanged."""
    out = {}
    for k, v in variables.items():
        v = np.asarray(v, np.float32)
        gain = 2.0
        if k.endswith("W") and v.ndim == 4:
            kh, kw, cin, _ = v.shape
            if not k.endswith(".W"):
                fan = (mdcl_taps or mdcl_fan_taps(variables, k[:-1])) * cin
                block = k[:-2] if k.endswith("2W") and f"{k[:-1]}bnorm0.gamma" not in variables else k[:-1]
                if f"{block}bnorm0.gamma" in variables:
                    gain = 1.0
            else:
                # a stride-2 deconv output pixel sees a quarter of the taps
                fan = kh * kw * cin / (4 if is_deconv(k) else 1)
        elif k.endswith(".W") and v.ndim == 2 and k[:-2] + MASK_SUFFIX in variables:
            out[k] = v * np.float32(iaf_logsigma_gain) if "_ls_output_" in k else v
            continue
        elif k.endswith(".W") and v.ndim == 2:
            fan = v.shape[0]
        else:
            out[k] = v
            continue
        out[k] = (v / v.std() * np.sqrt(gain / fan)).astype(np.float32)
    return out


def made_orderings_of(variables):
    """Recover each MADE net's latent ordering from its direct-input (DIML)
    mask. The mask is (ordering+1)[:, None] <= ordering[None, :] over a
    permutation of 0..D-1, so column j has exactly ordering[j] ones: the
    ordering is the column sum. Returns {made_name: ordering list}."""
    out = {}
    for k, v in variables.items():
        if k.endswith(DIRECT_MASK_SUFFIX):
            m = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            out[k[: -len(DIRECT_MASK_SUFFIX)]] = m.sum(axis=0).astype(np.int64).tolist()
    return out


def restore_made_masks(variables, metadata):
    """Regenerate MADE masks from the 'made_orderings' of checkpoint
    metadata, in place on port `variables`; each mask lands on the device of
    the one it replaces. No-op for files without the metadata, and for nets
    the model lacks."""
    for name, ordering in ((metadata or {}).get("made_orderings") or {}).items():
        if f"{name}_input{MASK_SUFFIX}" not in variables:
            continue
        n_hidden = 1
        while f"{name}_layer_{n_hidden}{MASK_SUFFIX}" in variables:
            n_hidden += 1
        names = mask_names(name, n_hidden)
        hidden = [variables[k].shape[1] for k in names[:n_hidden]]
        layer_masks, direct = made_masks(len(ordering), hidden, ordering=ordering)
        for k, m in zip(names, layer_masks + [direct]):
            variables[k] = torch.from_numpy(m).to(variables[k].device)
    return variables


def _check_version(metadata, fname):
    ver = (metadata or {}).get("format_version", 0)
    if ver > FORMAT_VERSION:
        raise ValueError(
            f"{fname} has checkpoint format_version {ver}, newer than this "
            f"build's {FORMAT_VERSION}; upgrade npe_tpu_torch to read it"
        )


def _unique_tmp(fname):
    """Per-writer temp path, so that two writers of one file never race on
    a shared temp name."""
    return f"{fname}.tmp-{os.getpid()}-{threading.get_ident()}-{uuid.uuid4().hex[:8]}.npz"


def save_weights(fname, variables, metadata=None, include_masks=False, compress=False):
    """Name-keyed save of port variables in npe_tpu's layout, with npe_tpu's
    signature. MADE masks are left out unless `include_masks`, as npe_tpu
    and the reference leave them out; each MADE net's ordering rides in the
    metadata so that `load_weights` regenerates the exact masks whatever
    mask seed the loading process would use. `compress` writes with
    `np.savez_compressed` (np.load reads both)."""
    save_arrays(fname, to_reference(variables), metadata, include_masks, compress)


def save_arrays(fname, arrays, metadata=None, include_masks=False, compress=False):
    """`save_weights` of arrays already in npe_tpu's layouts (name -> numpy
    array): npe_tpu's own `save_weights`, as the converter writes."""
    orderings = made_orderings_of(arrays)
    arrays = {k: np.asarray(v) for k, v in arrays.items() if include_masks or not k.endswith(MASK_SUFFIX)}
    metadata = dict(metadata or {})
    metadata.setdefault("format_version", FORMAT_VERSION)
    if orderings:
        metadata.setdefault("made_orderings", orderings)
    arrays[METADATA_KEY] = np.frombuffer(pickle.dumps(metadata), dtype=np.uint8)
    tmp = _unique_tmp(fname)
    try:
        with open(tmp, "wb") as f:
            (np.savez_compressed if compress else np.savez)(f, **arrays)
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_weights(fname, variables):
    """In-place name-matched restore into port `variables` (name -> tensor);
    each restored tensor lands on the device of the one it replaces. Returns
    the metadata dict ({} if none). A floating array takes the dtype of the
    tensor it replaces, as npe_tpu computes a float64 file in float32 (JAX
    runs with x64 off). Shape mismatches and missing names warn and skip;
    names the model lacks warn. MADE masks the file lacks are
    regenerated from the metadata's 'made_orderings' (else they stay as
    `variables` carries them from init)."""
    metadata = {}
    with np.load(fname, allow_pickle=False) as f:
        stored = {k: f[k] for k in f.files}
    if METADATA_KEY in stored:
        metadata = pickle.loads(stored.pop(METADATA_KEY).tobytes())
    _check_version(metadata, fname)
    restore_made_masks(variables, metadata)
    for name, old in variables.items():
        if name.endswith(MASK_SUFFIX) and name not in stored:
            continue  # regenerated above, or as drawn at init
        if name not in stored:
            logger.warning("checkpoint %s missing param %s; skipping", fname, name)
            continue
        arr = _to_port_layout(name, stored[name])
        if tuple(arr.shape) != tuple(old.shape):
            logger.warning(
                "shape mismatch for %s: checkpoint %s vs model %s (port layout); skipping",
                name,
                tuple(arr.shape),
                tuple(old.shape),
            )
            continue
        new = torch.from_numpy(np.ascontiguousarray(arr))
        if new.is_floating_point() and old.is_floating_point():
            new = new.to(old.dtype)
        variables[name] = new.to(old.device)
    for name in stored:
        if name not in variables:
            logger.warning("checkpoint %s has unused param %s", fname, name)
    return metadata


# --- train state -------------------------------------------------------------

BF16 = "bfloat16"


def _leaf_to_numpy(name, t):
    """A state tensor -> (host array in npe_tpu's layout, dtype name). numpy
    has no bfloat16: such a leaf travels as its raw 16-bit words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return np.require(_to_reference_layout(name, t.view(torch.int16).numpy().view(np.uint16)), requirements="C"), BF16
    arr = np.require(_to_reference_layout(name, t.numpy()), requirements="C")
    return arr, str(arr.dtype)


def _leaf_from_numpy(name, arr, dtype_name, device):
    arr = np.asarray(arr)
    if dtype_name == BF16 or arr.dtype.name == BF16:
        words = np.array(_to_port_layout(name, arr.view(np.uint16)), order="C").view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(_to_port_layout(name, arr), order="C")).to(device)


def _flat_train_state(state):
    """{leaf path: (variable name, value)} over a train state, in a fixed
    order. The variable name decides a 4-D leaf's layout: a moment takes its
    parameter's."""
    flat = {}
    for part, variables in state["parts"].items():
        for k, v in variables.items():
            flat[f"parts/{part}/{k}"] = (k, v)
    for part, opt in state["opt"].items():
        flat[f"opt/{part}/count"] = ("", opt["count"])
        for moment in ("mu", "nu"):
            for k, v in opt[moment].items():
                flat[f"opt/{part}/{moment}/{k}"] = (k, v)
    flat["step"] = ("", state["step"])
    return flat


def _nest_train_state(flat):
    """The inverse of `_flat_train_state` over {leaf path: value}."""
    state = {"parts": {p: {} for p in ("discrim", "latent", "gen", "frozen", "state")}, "opt": {}}
    for path, v in flat.items():
        keys = path.split("/", 3 if path.startswith("opt/") else 2)
        node = state
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    return state


def _opt_fields(opt):
    """An Adam state as (count, mu, nu): a dict, or a named tuple with those
    fields, as optax's ScaleByAdamState is."""
    if isinstance(opt, dict):
        return opt["count"], opt["mu"], opt["nu"]
    return opt.count, opt.mu, opt.nu


def train_state_from_reference(state_np, device):
    """An npe_tpu train state, as a nested dict of numpy arrays ({"parts":
    {gen, latent, discrim, frozen, state}, "opt": {gen, latent, discrim:
    {count, mu, nu}}, "step"}), -> the port's train state on `device`.
    Kernels move with `from_reference`'s rules; a moment takes its
    parameter's layout; bfloat16 moments (ml_dtypes arrays) stay bfloat16."""
    opt = {}
    for part, o in state_np["opt"].items():
        count, mu, nu = _opt_fields(o)
        opt[part] = {"count": count, "mu": mu, "nu": nu}
    flat = _flat_train_state({"parts": state_np["parts"], "opt": opt, "step": state_np["step"]})
    return _nest_train_state({
        path: _leaf_from_numpy(name, v, None, device) for path, (name, v) in flat.items()
    })


def train_state_to_reference(state):
    """The port's train state -> a nested dict of numpy arrays shaped like
    npe_tpu's, in npe_tpu's layouts; the exact inverse of
    `train_state_from_reference`. bfloat16 moments come back as ml_dtypes
    bfloat16 arrays (ml_dtypes is imported only when there are any)."""
    out = {}
    for path, (name, t) in _flat_train_state(state).items():
        arr, dtype_name = _leaf_to_numpy(name, t)
        if dtype_name == BF16:
            import ml_dtypes

            arr = arr.view(ml_dtypes.bfloat16)
        out[path] = arr
    return _nest_train_state(out)


def save_train_state(fname, state, metadata=None):
    """state: the port's train state (`training.train_step`). metadata (e.g.
    {'epoch', 'itr', 'learning_rate'}) rides in the file so that a resume
    restores epoch and lr CONSISTENT with the moments even when state saves
    are throttled to every Nth checkpoint (train.py `state_every`).
    Uncompressed: a train state is about three times the weights, and zlib on
    float noise costs far more time than it saves bytes."""
    arrays, leaf_dtypes = {}, {}
    for path, (name, t) in _flat_train_state(state).items():
        arrays[path], leaf_dtypes[path] = _leaf_to_numpy(name, t)
    metadata = dict(metadata or {})
    metadata.setdefault("format_version", FORMAT_VERSION)
    # bfloat16 Adam moments (cfg['moments_dtype']) are stored as raw 16-bit
    # words: each leaf's true dtype is recorded so that load views them back.
    metadata.setdefault("leaf_dtypes", leaf_dtypes)
    arrays[METADATA_KEY] = np.frombuffer(pickle.dumps(metadata), dtype=np.uint8)
    tmp = _unique_tmp(fname)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_train_state(fname, device="cuda"):
    """The train state of `fname` on `device` (the card unless the caller
    names another; without one it raises). Refuses a file newer than
    FORMAT_VERSION."""
    from npe_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    with np.load(fname, allow_pickle=False) as f:
        stored = {k: f[k] for k in f.files}
    metadata = pickle.loads(stored.pop(METADATA_KEY).tobytes()) if METADATA_KEY in stored else {}
    _check_version(metadata, fname)
    leaf_dtypes = metadata.get("leaf_dtypes", {})
    flat = {}
    for path, arr in stored.items():
        keys = path.split("/", 3 if path.startswith("opt/") else 2)
        name = keys[-1] if len(keys) > 2 and keys[-1] != "count" else ""
        flat[path] = _leaf_from_numpy(name, arr, leaf_dtypes.get(path), device)
    return _nest_train_state(flat)


def train_state_metadata(fname):
    """Read only the metadata member of a train-state npz (cheap: one zip
    entry, no leaf arrays touched)."""
    with np.load(fname, allow_pickle=False) as f:
        if METADATA_KEY not in f.files:
            return {}
        meta = pickle.loads(f[METADATA_KEY].tobytes())
    meta.pop("leaf_dtypes", None)  # internal (see save_train_state)
    return meta


class AsyncCheckpointer:
    """Overlap a checkpoint's device-to-host copy and file write with
    training, on one worker thread.

    The training steps never update a tensor in place (`training/
    train_step.py`): a step allocates the new state, so a reference to the
    epoch-N state stays valid and unchanged while the main thread trains
    epoch N+1, and the worker can copy it out at its own pace.

    At most one save is in flight (`submit` joins the previous one first):
    saves stay ordered, the extra device memory is bounded to one retained
    state, and each file still lands via an atomic temp file and rename, so
    a crash loses at most the newest checkpoint. Call `wait()` before reading
    the files back and at the end of training. An exception from the worker
    is re-raised on the NEXT submit / wait / close.
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._inflight = None

    def submit(self, fn, *args, **kwargs):
        self.wait()
        self._inflight = self._pool.submit(fn, *args, **kwargs)

    def wait(self):
        if self._inflight is not None:
            f, self._inflight = self._inflight, None
            f.result()

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)
