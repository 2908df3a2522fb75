"""The editor's fused DELTA / mask / composite tail.

Replaces the Pallas TPU kernel `npe_tpu/ops/pallas/editor_kernels.py:edit_tail`.
The kernel is `npe_tpu_torch/csrc/edit_tail.cu` (its header says what bounds
it and how it is laid out); `edit_tail_reference` is its plain PyTorch
version, a copy of npe_tpu's `edit_tail_reference` with its `blur_matrix`.

`edit_tail` takes images (n, n, 3) or a batch (b, n, n, 3), float32, HWC,
n a multiple of 4. For CPU tensors it runs the plain version; for CUDA
tensors it launches the kernel, or raises. The kernel cuts each image into
bands of rows (`band_rows`) that run as independent blocks.
`edit_tail.launches` counts the kernel's launches.
"""

import ctypes
import functools

import numpy as np
import torch

from npe_tpu_torch.ops.filters import gaussian_kernel_1d, reflect_index
from npe_tpu_torch.ops.kernels import build

SOURCE = "npe_tpu_torch/csrc/edit_tail.cu"
REPLACES = "npe_tpu/ops/pallas/editor_kernels.py:76"
# The launch asks for no more than the default 48 KB of dynamic shared
# memory, which must hold a band's m with its halo, its H-blurred rows and the
# taps (`edit_tail_smem_bytes`).
SMEM_LIMIT = 48 * 1024


@functools.lru_cache(maxsize=8)
def _blur_matrix_np(n, sigma, truncate):
    k, r = gaussian_kernel_1d(sigma, truncate)
    b = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(-r, r + 1):
            b[i, reflect_index(i + t, n)] += k[t + r]
    return b


def blur_matrix(n, sigma=0.7, truncate=4.0, device="cpu"):
    """(n, n) operator: (blur_matrix @ v) == scipy 1-D gaussian_filter(v)
    with mode='reflect'."""
    return torch.from_numpy(_blur_matrix_np(n, float(sigma), float(truncate))).to(device)


def edit_tail_reference(xh, recon, error, bm, user_mask=None):
    """Plain version. Images (..., H, W, 3); bm is blur_matrix(H); user_mask
    an optional (..., H, W) additive mask floor: mask = clip(blur +
    user_mask, 0, 1)."""
    delta = xh - recon
    m = torch.clamp(delta.abs().mean(dim=-1), max=1.0)
    mask = bm @ m @ bm.T
    if user_mask is not None:
        mask = torch.clamp(mask + user_mask, 0.0, 1.0)
    mask = mask[..., None]
    return recon + mask * delta + (1.0 - mask) * error


@functools.lru_cache(maxsize=16)
def _taps(sigma, device):
    """The 1-D Gaussian taps on `device`, cached per (sigma, device)."""
    k, r = gaussian_kernel_1d(sigma)
    return torch.from_numpy(k).to(device), r


def edit_tail_smem_bytes(n, rows, radius):
    """Shared memory of one block: m over its `rows` rows and `radius` rows
    either side, the H-blurred rows, and the 2 radius + 1 taps."""
    return ((rows + 2 * radius) * n + rows * n + 2 * radius + 1) * 4


def band_rows(batch, n, radius, sm_count):
    """Rows of one band (a block of the kernel): the fewest, a divisor of n
    whose block fits SMEM_LIMIT, that keep all batch x n / rows blocks in
    one wave, one a multiprocessor; past that, the most that fit. One 64x64
    image takes 64 bands of one row, a batch of 8 bands of four rows, a
    batch of 128 whole images. None if not even one row fits."""
    fits = [r for r in range(1, n + 1) if n % r == 0 and edit_tail_smem_bytes(n, r, radius) <= SMEM_LIMIT]
    if not fits:
        return None
    return next((r for r in fits if batch * (n // r) <= sm_count), fits[-1])


@functools.cache
def _entry():
    fn = build.load("edit_tail").npe_edit_tail
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def _geometry(batch, n, radius, device):
    return band_rows(batch, n, radius, torch.cuda.get_device_properties(device).multi_processor_count)


def _check(xh, recon, error, user_mask, radius):
    if xh.ndim != 4 or xh.shape[-1] != 3 or xh.shape[1] != xh.shape[2] or xh.shape[0] < 1:
        raise ValueError(f"edit_tail wants (n, n, 3) or (b, n, n, 3) images, got {tuple(xh.shape)}")
    tensors = {"xh": xh, "recon": recon, "error": error}
    if user_mask is not None:
        tensors["user_mask"] = user_mask
        if tuple(user_mask.shape) != tuple(xh.shape[:3]):
            raise ValueError(
                f"user_mask shape {tuple(user_mask.shape)} does not match images {tuple(xh.shape)}"
            )
    for name, t in tensors.items():
        if name != "user_mask" and t.shape != xh.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != xh shape {tuple(xh.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"edit_tail wants float32, got {name} {t.dtype}")
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
        if not t.is_contiguous():
            raise ValueError(f"edit_tail wants contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"edit_tail wants 16-byte aligned tensors; {name} is not")
    n = xh.shape[1]
    if n % 4:
        raise ValueError(f"edit_tail reads rows as float4: n must be a multiple of 4, got {n}")
    if edit_tail_smem_bytes(n, 1, radius) > SMEM_LIMIT:
        raise ValueError(
            f"edit_tail: n={n} at radius {radius} needs {edit_tail_smem_bytes(n, 1, radius)} B of shared memory "
            "for a band of one row")


def edit_tail(xh, recon, error, user_mask=None, sigma=0.7):
    """Fused DELTA/MASK/composite: recon + mask*(xh - recon) + (1-mask)*error
    with mask = blur(min(mean_c|xh - recon|, 1)) (+ user_mask, clipped)."""
    single = xh.ndim == 3
    if single:
        xh, recon, error = xh[None], recon[None], error[None]
        user_mask = None if user_mask is None else user_mask[None]
    _, radius = gaussian_kernel_1d(sigma)
    _check(xh, recon, error, user_mask, radius)
    if xh.device.type == "cpu":
        bm = blur_matrix(xh.shape[1], sigma, device=xh.device)
        out = edit_tail_reference(xh, recon, error, bm, user_mask)
    elif xh.device.type == "cuda":
        out = torch.empty_like(xh)
        taps, _ = _taps(float(sigma), xh.device)
        with torch.cuda.device(xh.device):
            rc = _entry()(
                xh.data_ptr(),
                recon.data_ptr(),
                error.data_ptr(),
                None if user_mask is None else user_mask.data_ptr(),
                taps.data_ptr(),
                radius,
                out.data_ptr(),
                xh.shape[0],
                xh.shape[1],
                _geometry(xh.shape[0], xh.shape[1], radius, xh.device),
                torch.cuda.current_stream(xh.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"edit_tail kernel launch failed with CUDA error {rc}")
        edit_tail.launches += 1
    else:
        raise ValueError(f"edit_tail runs on cpu or cuda tensors, got {xh.device}")
    return out[0] if single else out


edit_tail.launches = 0
