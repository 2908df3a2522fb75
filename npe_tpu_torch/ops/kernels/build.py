"""Build and load the port's CUDA C++ kernels.

Each `npe_tpu_torch/csrc/<name>.cu` exposes a plain C entry point and is
compiled by `nvcc` for sm_90a into its own shared library, loaded with
ctypes. A library is built at first use into `npe_tpu_torch/_build/` (kept
out of git), named by a hash of the sources and flags, so a changed source
is rebuilt and an unchanged one is not.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import uuid

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, per kernel
)

_loaded = {}
_lock = threading.Lock()


def kernel_names():
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name):
    """Compile kernel `name` unless its library exists, and atomically
    publish it. Returns nvcc's output ('' if nothing was built)."""
    so = library_path(name)
    if os.path.exists(so):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    src = os.path.join(CSRC, f"{name}.cu")
    try:
        r = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}) building {so}:\n{r.stdout}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return r.stdout


def load(name):
    """The ctypes library of kernel `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
        return lib
