"""Training-chunk staging: uint8 images to float32 in [-1, 1], rows gathered
by an index vector, in one launch.

Replaces the Pallas TPU kernel
`npe_tpu/ops/pallas/staging.py:stage_uint8_to_tanh` and the gather that
npe_tpu's `stage_chunk` fuses with it. The kernel is
`npe_tpu_torch/csrc/staging.cu` (its header says what bounds it and how it is
laid out); `stage_chunk_reference` is its plain PyTorch version. The host
ships raw uint8 bytes (a quarter of the float32 traffic) or keeps the whole
uint8 dataset on the card, and the range change happens there.

Images stay NCHW, as the port's activations are: (M, C, H, W) uint8 in,
(n, C, H, W) float32 out. (npe_tpu emits NHWC.) The input is data: there is
no gradient.

`stage_chunk` runs the plain version for CPU tensors; for CUDA tensors it
launches the kernel, or raises. `stage_chunk.launches` counts launches.
"""

import ctypes
import functools

import numpy as np
import torch

from npe_tpu_torch.ops.kernels import add_launches, build
from npe_tpu_torch.utils.profiling import annotate

SOURCE = "npe_tpu_torch/csrc/staging.cu"
REPLACES = "npe_tpu/ops/pallas/staging.py:40"
PIECE = 16  # bytes: every row of the input and of the output starts on such a boundary


def stage_chunk_reference(chunk_u8, perm=None):
    """Plain version: `index_select`, cast, x * (2/255) - 1."""
    if perm is not None:
        chunk_u8 = chunk_u8.index_select(0, perm)
    return chunk_u8.to(torch.float32) * (2.0 / 255.0) - 1.0


@functools.cache
def _entry():
    fn = build.load("staging").npe_stage_chunk
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _device_indices(perm, num_rows, device):
    """`perm` as an int32 or int64 tensor on `device`. Indices that come from
    the host (a numpy array, a list, a CPU tensor) are checked against
    [0, num_rows) there, before the copy and without a device
    synchronisation; a tensor already on a CUDA device is taken as checked."""
    if isinstance(perm, torch.Tensor) and perm.device.type == "cuda":
        if perm.device != device:
            raise ValueError(f"stage_chunk: perm is on {perm.device}, the chunk on {device}")
        idx = perm
    else:
        host = perm.numpy() if isinstance(perm, torch.Tensor) else np.asarray(perm)
        if host.dtype.kind not in "iu":
            raise TypeError(f"stage_chunk wants integer indices, got {host.dtype}")
        if host.size and (host.min() < 0 or host.max() >= num_rows):
            raise IndexError(
                f"stage_chunk: indices span [{host.min()}, {host.max()}], the chunk has {num_rows} rows"
            )
        if host.dtype not in (np.int32, np.int64):
            host = host.astype(np.int64)
        with annotate("npe.wait"):  # a copy from pageable memory waits for the card
            idx = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"stage_chunk wants int32 or int64 indices, got {idx.dtype}")
    if idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError(f"stage_chunk wants a contiguous index vector, got shape {tuple(idx.shape)}")
    return idx


def stage_chunk(chunk_u8, perm=None):
    """Gather by `perm` + uint8 -> float32 + [0, 255] -> [-1, 1], fused.

    chunk_u8: (M, C, H, W) torch.uint8, contiguous: a chunk, or the whole
    dataset resident on the card. perm: an int32 / int64 index vector of any
    length n (the per-chunk shuffle, repeats allowed), None for the identity.
    Returns (n, C, H, W) float32 on the chunk's device.

    Host indices are checked here; an index tensor that already lies on the
    card is trusted, because checking it would synchronise the device: the
    kernel reads whatever row it names. Under a profiler the call is one
    span, `npe.stage_chunk`."""
    with annotate("npe.stage_chunk"):
        return _stage(chunk_u8, perm)


def _stage(chunk_u8, perm):
    """`stage_chunk` without its span (a captured body calls it)."""
    if not isinstance(chunk_u8, torch.Tensor) or chunk_u8.dtype != torch.uint8:
        kind = chunk_u8.dtype if isinstance(chunk_u8, torch.Tensor) else type(chunk_u8).__name__
        raise TypeError(f"stage_chunk wants a torch.uint8 tensor, got {kind}")
    if chunk_u8.ndim != 4 or not chunk_u8.is_contiguous():
        raise ValueError(
            f"stage_chunk wants a contiguous (M, C, H, W) tensor, got shape {tuple(chunk_u8.shape)}"
            f"{'' if chunk_u8.is_contiguous() else ', not contiguous'}"
        )
    device = chunk_u8.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"stage_chunk runs on cpu or cuda tensors, got {device}")
    m, c, h, w = chunk_u8.shape
    chw = c * h * w
    if chw % PIECE or chunk_u8.data_ptr() % PIECE:
        raise ValueError(
            f"stage_chunk wants C*H*W a multiple of {PIECE} and a {PIECE}-byte aligned chunk, "
            f"got C*H*W = {chw}"
        )
    idx = None if perm is None else _device_indices(perm, m, device)
    if device.type == "cpu":
        return stage_chunk_reference(chunk_u8, idx)
    n = m if idx is None else idx.shape[0]
    out = torch.empty((n, c, h, w), dtype=torch.float32, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        rc = _entry()(
            chunk_u8.data_ptr(), None if idx is None else idx.data_ptr(),
            int(idx is not None and idx.dtype == torch.int64), out.data_ptr(),
            n, chw, torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"staging kernel launch failed with CUDA error {rc}")
    add_launches(stage_chunk)
    return out


stage_chunk.launches = 0


def stage_uint8_to_tanh(chunk_u8):
    """chunk_u8: (N, C, H, W) uint8 -> (N, C, H, W) float32 in [-1, 1]; no
    span: the server's captured encode calls it."""
    return _stage(chunk_u8, None)
