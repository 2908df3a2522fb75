"""ctypes bindings for the native C++ chunk loader, `native/loader.cpp`
(npe_tpu `data/native_loader.py`): an mmap'ed raw uint8 record file, a
seeded per-epoch shuffle (std::mt19937_64, so the same seed gives npe_tpu's
chunk order) and a background thread that gathers the next chunks while the
card trains on the current one.

The C++ source is framework-free and shared with npe_tpu, and read as it is.
The port builds its own library from it with g++ at first use, into the
git-ignored `npe_tpu_torch/_build/` beside the CUDA kernels, named by a hash
of the source and the flags and published by an atomic rename, so that
concurrent processes never race on one file (npe_tpu writes its own library
under `native/`, which the port never touches). Without a compiler or with a
failed build, `get_lib` raises: there is no Python fallback.

    export_raw(dataset, "train.raw")          # one-time conversion
    for chunk in native_chunk_loader(cfg, "train.raw", num, shuffle=True,
                                     seed=epoch, offset=off, raw=True):
        ...  # uint8 (chunk, 3, 64, 64), staged on the card by stage_chunk
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid

import numpy as np

from npe_tpu_torch.utils.ranges import to_tanh

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "loader.cpp")
BUILD_DIR = os.path.join(_REPO, "npe_tpu_torch", "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnpeloader-{h.hexdigest()[:16]}.so")


def build():
    """Compile the loader unless its library exists; returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native loader needs g++ to build native/loader.cpp; none is on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) building {so}:\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def get_lib():
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.npe_loader_open.restype = ctypes.c_void_p
        lib.npe_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int]
        lib.npe_loader_begin_epoch.restype = None
        lib.npe_loader_begin_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int64]
        lib.npe_loader_chunks_per_epoch.restype = ctypes.c_int64
        lib.npe_loader_chunks_per_epoch.argtypes = [ctypes.c_void_p]
        lib.npe_loader_next.restype = ctypes.c_int64
        lib.npe_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.npe_loader_close.restype = None
        lib.npe_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def export_raw(dataset, path, batch=256):
    """Write any dataset (get_data / num_examples) to a raw uint8 record
    file; returns (num_records, record_shape)."""
    shape = np.asarray(dataset.get_data([0])).shape[1:]
    with open(path, "wb") as f:
        for start in range(0, dataset.num_examples, batch):
            idx = list(range(start, min(start + batch, dataset.num_examples)))
            f.write(np.ascontiguousarray(np.uint8(dataset.get_data(idx))).tobytes())
    return dataset.num_examples, shape


def num_records(path, record_shape=(3, 64, 64)):
    """Records a raw file holds: its size over a record's bytes."""
    return os.path.getsize(path) // int(np.prod(record_shape))


class NativeChunkLoader:
    """Owns one C loader (its mapping and prefetch thread): `close` ends it."""

    def __init__(self, path, num_records, record_shape, chunk_records, n_prefetch=2):
        self.lib = get_lib()
        self.record_shape = tuple(record_shape)
        self.chunk_records = chunk_records
        record_bytes = int(np.prod(self.record_shape))
        self._h = self.lib.npe_loader_open(str(path).encode(), num_records, record_bytes, chunk_records, n_prefetch)
        if not self._h:
            raise OSError(f"npe_loader_open failed for {path} ({num_records} records of {record_bytes} bytes)")
        self._buf = np.empty((chunk_records, *self.record_shape), np.uint8)

    def epoch(self, shuffle=True, seed=0, offset=0):
        """The epoch's chunks, each a fresh uint8 array."""
        if not self._h:
            raise ValueError("the loader is closed")
        self.lib.npe_loader_begin_epoch(self._h, int(bool(shuffle)), seed, offset)
        for _ in range(int(self.lib.npe_loader_chunks_per_epoch(self._h))):
            got = self.lib.npe_loader_next(self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if got == 0:
                return
            yield self._buf[:got].copy()  # the buffer is reused by the next chunk

    def close(self):
        if getattr(self, "_h", None):
            self.lib.npe_loader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def native_chunk_loader(cfg, path, num_records, record_shape=(3, 64, 64), offset=0, shuffle=False, seed=42,
                        loader=None, raw=False):
    """`data.data_loader`'s counterpart over the native prefetcher: float32
    chunks in [-1, 1], or (raw=True) uint8 chunks for the staging kernel.
    `loader`: an open NativeChunkLoader to draw from (kept open), else one
    is opened for this epoch and closed after it."""
    chunk = cfg["batch_size"] * cfg["batches_per_chunk"]
    own = loader is None
    if own:
        loader = NativeChunkLoader(path, num_records, record_shape, chunk)
    try:
        for u8 in loader.epoch(shuffle=shuffle, seed=seed, offset=offset):
            yield u8 if raw else to_tanh(np.float32(u8))
    finally:
        if own:
            loader.close()
