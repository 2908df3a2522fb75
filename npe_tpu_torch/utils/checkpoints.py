"""Checkpointing, on `npe_tpu`'s file ABI (`npe_tpu/utils/checkpoints.py`).

A weight file is a name-keyed .npz of arrays in `npe_tpu`'s layouts (conv
kernels HWIO, deconv kernels (kh, kw, cin, cout), dense rows in NHWC-flatten
order) plus a pickled metadata dict, written atomically through a unique
temp file. Restore is name-matched; a shape mismatch or a missing name warns
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

logger = logging.getLogger(__name__)

METADATA_KEY = "__metadata__"
# Same history as npe_tpu: v0 unversioned, v1 adds the stamp; same arrays.
FORMAT_VERSION = 1

# Deconv kernels are the 4-D weights of the decoder's layers (`dec_*`,
# npe_tpu's `VarBuilder.deconv`); every other 4-D weight is a conv kernel.
_DECONV_PREFIX = "dec_"


def _is_deconv(name):
    return name.startswith(_DECONV_PREFIX)


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


def unit_gain(variables):
    """npe_tpu variables (name -> array) with each weight kernel rescaled to
    a He-style std sqrt(2 / fan_in), as numpy float32; names, shapes and all
    other arrays unchanged. Both packages' inits draw kernels from
    Normal(0.02), under which activations shrink layer by layer until any two
    implementations agree within atol 1e-4 whatever they compute; at unit
    gain they stay O(1), so comparisons of two devices or two packages on
    seeded weights mean something."""
    out = {}
    for k, v in variables.items():
        v = np.asarray(v, np.float32)
        if k.endswith(".W") and v.ndim == 4:
            kh, kw, cin, _ = v.shape
            # a stride-2 deconv output pixel sees a quarter of the taps
            fan = kh * kw * cin / (4 if _is_deconv(k) else 1)
        elif k.endswith(".W") and v.ndim == 2:
            fan = v.shape[0]
        else:
            out[k] = v
            continue
        out[k] = (v / v.std() * np.sqrt(2.0 / fan)).astype(np.float32)
    return out


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
    """Name-keyed save of port variables in npe_tpu's layout."""
    arrays = to_reference(variables)
    metadata = dict(metadata or {})
    metadata.setdefault("format_version", FORMAT_VERSION)
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
    and skip; names the model lacks warn."""
    metadata = {}
    with np.load(fname, allow_pickle=False) as f:
        stored = {k: f[k] for k in f.files}
    if METADATA_KEY in stored:
        metadata = pickle.loads(stored.pop(METADATA_KEY).tobytes())
    _check_version(metadata, fname)
    for name, old in variables.items():
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
