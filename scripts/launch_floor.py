"""The launch floor of a small kernel on an NVIDIA GPU: an empty kernel
launched with the grid and block the kernel would be given. A kernel's time
is read beside it (chip_smoke.py, scripts/kernel_ab.py), since no design of
the kernel can go below it. Not part of the package, which launches only
what the models run. Built with the package's nvcc flags into
npe_tpu_torch/_build/ at first use.
"""

import ctypes
import functools
import os
import subprocess

import torch

from npe_tpu_torch.ops.filters import gaussian_kernel_1d
from npe_tpu_torch.ops.kernels import build
from npe_tpu_torch.ops.kernels import edit_tail as et

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int npe_launch_floor(int grid_x, int grid_y, int threads, void* stream) {
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


@functools.cache
def _entry():
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    stem = os.path.join(build.BUILD_DIR, f"launch_floor-{os.getpid()}")  # one build a process
    with open(f"{stem}.cu", "w") as f:
        f.write(SOURCE)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", f"{stem}.so", f"{stem}.cu"],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the empty kernel:\n{r.stdout}")
    fn = ctypes.CDLL(f"{stem}.so").npe_launch_floor
    for path in (f"{stem}.cu", f"{stem}.so"):  # the loaded library stays mapped
        os.remove(path)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def edit_tail_floor(batch, n=64, sigma=0.7, device="cuda"):
    """One launch of the empty kernel, on the current stream, with the grid
    and block edit_tail launches with: (n / rows, batch) blocks of
    `block_threads(n, radius, rows)` threads (csrc/edit_tail.cu)."""
    _, radius = gaussian_kernel_1d(sigma)
    rows = et.band_rows(batch, n, radius, torch.cuda.get_device_properties(device).multi_processor_count)
    threads = min(1024, max(64, (max((rows + 2 * radius) * (n // 4), rows * n) + 31) // 32 * 32))
    rc = _entry()(n // rows, batch, threads, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the empty kernel failed to launch with CUDA error {rc}")
