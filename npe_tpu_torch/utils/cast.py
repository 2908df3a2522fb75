"""The dtypes of the inference path, and the cast of a model's variables to
one of them (npe_tpu `utils/cast.py`).

The port runs its models in the dtype of their weights: `api.IAN`,
`EditSession` and `InferenceServer` draw or load the weights in float32,
cast them once with `cast_floating`, and cast their inputs at the model's
boundary. No autocast: every op then rounds where npe_tpu's explicit cast
rounds, and the hand kernels pick their form by the dtype they are given.
"""

import numpy as np
import torch

# The dtypes the port computes in: the hand kernels have these two forms.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype):
    """The torch dtype that a caller's `dtype=` names. None, torch.float32,
    np.float32 and "float32" give torch.float32; torch.bfloat16 and
    "bfloat16" give torch.bfloat16. Any other dtype raises ValueError."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str) and dtype in DTYPES:
        return DTYPES[dtype]
    if dtype in DTYPES.values():
        return dtype
    try:
        if not isinstance(dtype, (str, torch.dtype)) and np.dtype(dtype) == np.float32:
            return torch.float32
    except TypeError:
        pass
    raise ValueError(f"dtype={dtype!r}: the port computes in float32 or bfloat16 only")


def cast_floating(variables, dtype=torch.bfloat16):
    """A new dict with every floating tensor of `variables` (the flat dict of
    a model's variables) cast to `dtype`; integer and bool tensors as they
    are."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in variables.items()}
