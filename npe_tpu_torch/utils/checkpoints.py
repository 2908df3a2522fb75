"""Checkpointing, on `npe_tpu`'s file ABI (`npe_tpu/utils/checkpoints.py`).

A weight file is a name-keyed .npz of arrays in `npe_tpu`'s layouts (conv
kernels HWIO, deconv kernels (kh, kw, cin, cout), dense rows in NHWC-flatten
order) plus a pickled metadata dict, written atomically through a unique
temp file. MADE masks (`*.weights_mask`) are left out of the file: each MADE
net's ordering rides in the metadata (`made_orderings`) and the masks are
regenerated from it at load. Restore is name-matched; a shape mismatch or a missing name warns
and skips, and a file newer than `FORMAT_VERSION` is refused. Files written
by `npe_tpu` load here and files written here load into `npe_tpu`.

Layouts change only at this boundary: `from_reference` turns `npe_tpu`'s
arrays into the port's tensors and `to_reference` is its exact inverse.
"""

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


def _is_deconv(name):
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
    return arr.transpose(2, 3, 0, 1) if _is_deconv(name) else arr.transpose(3, 2, 0, 1)


def _to_reference_layout(name, arr):
    if arr.ndim != 4:
        return arr
    return arr.transpose(2, 3, 0, 1) if _is_deconv(name) else arr.transpose(2, 3, 1, 0)


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


def unit_gain(variables, mdcl_taps=3.0, iaf_logsigma_gain=1.0):
    """Seeded weights for comparisons, not for training: npe_tpu variables (name -> array) with each weight kernel rescaled to
    a He-style std sqrt(2 / fan_in), as numpy float32; names, shapes and all
    other arrays unchanged. Both packages' inits draw kernels from
    Normal(0.02), under which activations shrink layer by layer until any two
    implementations agree within atol 1e-4 whatever they compute; at unit
    gain they stay O(1), so comparisons of two devices or two packages on
    seeded weights mean something.

    MDCL filters (4-D, names ending in a bare `W`) take the fan
    `mdcl_taps * cin`: how many taps' worth of variance per input channel a
    pre-activation of the composed kernel sees. The default 3 is that of the
    RGB-Beta head as initialized, scales [2, 3, 4] with every coefficient
    1/4: the centre tap sums to the filter's own and each of the other 32
    taps carries a quarter of one, 1 + 32/16 = 3. Another scale set or other
    coefficients want another value. MADE weights (2-D, beside a
    `.weights_mask`) are left as drawn, their orthogonal init at gain sqrt(2)
    being unit gain already, except that the IAF log-sigma net's output
    layers (`*_ls_output_*.W`) are multiplied by `iaf_logsigma_gain`: a
    caller that passes 0.1 keeps exp(logsigma) near 1, so that the flow does
    not throw latents far outside the decoder's range. Masks, biases, BN
    state and MDCL coefficients pass unchanged."""
    out = {}
    for k, v in variables.items():
        v = np.asarray(v, np.float32)
        if k.endswith("W") and v.ndim == 4:
            kh, kw, cin, _ = v.shape
            if not k.endswith(".W"):
                fan = mdcl_taps * cin
            else:
                # a stride-2 deconv output pixel sees a quarter of the taps
                fan = kh * kw * cin / (4 if _is_deconv(k) else 1)
        elif k.endswith(".W") and v.ndim == 2 and k[:-2] + MASK_SUFFIX in variables:
            out[k] = v * np.float32(iaf_logsigma_gain) if "_ls_output_" in k else v
            continue
        elif k.endswith(".W") and v.ndim == 2:
            fan = v.shape[0]
        else:
            out[k] = v
            continue
        out[k] = (v / v.std() * np.sqrt(2.0 / fan)).astype(np.float32)
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


def save_weights(fname, variables, metadata=None):
    """Name-keyed save of port variables in npe_tpu's layout. MADE masks are
    left out, as npe_tpu and the reference leave them out; each MADE net's
    ordering rides in the metadata so that `load_weights` regenerates the
    exact masks whatever mask seed the loading process would use."""
    arrays = to_reference({k: v for k, v in variables.items() if not k.endswith(MASK_SUFFIX)})
    metadata = dict(metadata or {})
    metadata.setdefault("format_version", FORMAT_VERSION)
    orderings = made_orderings_of(variables)
    if orderings:
        metadata.setdefault("made_orderings", orderings)
    arrays[METADATA_KEY] = np.frombuffer(pickle.dumps(metadata), dtype=np.uint8)
    tmp = _unique_tmp(fname)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_weights(fname, variables):
    """In-place name-matched restore into port `variables` (name -> tensor);
    each restored tensor lands on the device of the one it replaces. Returns
    the metadata dict ({} if none). Shape mismatches and missing names warn
    and skip; names the model lacks warn. MADE masks the file lacks are
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
        variables[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(old.device)
    for name in stored:
        if name not in variables:
            logger.warning("checkpoint %s has unused param %s", fname, name)
    return metadata
