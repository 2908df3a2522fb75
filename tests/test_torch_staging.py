"""npe_tpu_torch's chunk staging (`ops/kernels/staging.py`) against npe_tpu's
(`ops/pallas/staging.py`) on the CPU, where the wrapper runs its plain version:
the same uint8 bytes and index vectors go through both. npe_tpu emits NHWC,
the port NCHW, so npe_tpu's result is transposed back. Tolerance: max abs
1e-6; the forms `x * (2/255) - 1` (the kernels) and `2 * (x / 255) - 1`
(npe_tpu's non-Pallas path) agree within one float32 step near +-1."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.ops.pallas import staging as jstaging
from npe_tpu_torch.ops.kernels import build
from npe_tpu_torch.ops.kernels import staging

tp.torch_threads()
ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-6


def _chunk(m, shape=(3, 16, 16), seed=3):
    rng = np.random.RandomState(seed)
    chunk = rng.randint(0, 256, (m, *shape), dtype=np.uint8)
    chunk.reshape(-1)[:256] = np.arange(256)  # every byte value
    return chunk


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("perm_kind", ["none", "permutation", "repeats", "one", "short"])
def test_plain_version_matches_npe_tpu_stage_chunk(perm_kind):
    chunk = _chunk(12)
    rng = np.random.RandomState(0)
    perm = {"none": None, "permutation": rng.permutation(12), "repeats": rng.randint(0, 12, 20),
            "one": np.array([7]), "short": np.array([11, 0, 3])}[perm_kind]
    want = _nchw(jstaging.stage_chunk(chunk, perm, use_pallas=False))
    before = staging.stage_chunk.launches
    got = staging.stage_chunk(torch.from_numpy(chunk), perm)
    assert staging.stage_chunk.launches == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert got.min() >= -1 - TOL and got.max() <= 1 + TOL
    src = chunk if perm is None else chunk[perm]
    assert float(got[src == 0].max()) == -1.0 and abs(float(got[src == 255].min()) - 1.0) <= TOL


def test_plain_version_matches_the_pallas_kernel_in_interpret_mode():
    chunk = _chunk(4)
    want = _nchw(jstaging.stage_uint8_to_tanh(jnp.asarray(chunk), interpret=True))
    got = staging.stage_uint8_to_tanh(torch.from_numpy(chunk))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.numpy(), staging.stage_chunk_reference(torch.from_numpy(chunk)).numpy())


@pytest.mark.parametrize("index_type", [np.int32, np.int64, np.uint8, "int32 tensor", "int64 tensor", "list"])
def test_index_types(index_type):
    chunk = torch.from_numpy(_chunk(9))
    perm = np.array([8, 0, 0, 5])
    want = staging.stage_chunk_reference(chunk, torch.from_numpy(perm))
    if index_type == "list":
        idx = perm.tolist()
    elif isinstance(index_type, str):
        idx = torch.from_numpy(perm.astype(index_type.split()[0]))
    else:
        idx = perm.astype(index_type)
    assert torch.equal(staging.stage_chunk(chunk, idx), want)


@pytest.mark.parametrize("bad", ["float input", "numpy input", "3-D", "not contiguous", "3x5x5", "index too large",
                                 "negative index", "float indices", "index matrix"])
def test_wrapper_raises_on_what_the_kernel_cannot_take(bad):
    chunk = torch.from_numpy(_chunk(6))
    perm = np.arange(6)
    raises = {
        "float input": (TypeError, lambda: staging.stage_chunk(chunk.float(), perm)),
        "numpy input": (TypeError, lambda: staging.stage_chunk(chunk.numpy(), perm)),
        "3-D": (ValueError, lambda: staging.stage_chunk(chunk[0], None)),
        "not contiguous": (ValueError, lambda: staging.stage_chunk(chunk.permute(0, 1, 3, 2), None)),
        "3x5x5": (ValueError, lambda: staging.stage_chunk(torch.zeros((2, 3, 5, 5), dtype=torch.uint8))),
        "index too large": (IndexError, lambda: staging.stage_chunk(chunk, np.array([0, 6]))),
        "negative index": (IndexError, lambda: staging.stage_chunk(chunk, np.array([-1, 2]))),
        "float indices": (TypeError, lambda: staging.stage_chunk(chunk, np.array([0.0, 1.0]))),
        "index matrix": (ValueError, lambda: staging.stage_chunk(chunk, np.zeros((2, 2), np.int64))),
    }
    error, call = raises[bad]
    with pytest.raises(error, match="stage_chunk"):
        call()


def test_full_size_images_and_an_empty_index_vector():
    chunk = torch.from_numpy(_chunk(3, (3, 64, 64)))
    out = staging.stage_chunk(chunk, np.array([2, 2, 1]))
    assert tuple(out.shape) == (3, 3, 64, 64) and torch.equal(out[0], out[1])
    assert tuple(staging.stage_chunk(chunk, np.zeros(0, np.int64)).shape) == (0, 3, 64, 64)


def test_the_kernel_source_is_what_the_wrapper_says():
    """No compiler here: hold the source to what the wrapper binds and what
    the build route finds."""
    assert "staging" in build.kernel_names()
    src = (ROOT / staging.SOURCE).read_text()
    assert re.search(r'extern "C" int npe_stage_chunk\(const void\* src, const void\* idx, int idx_is_64, void\* out,\s*'
                     r"int n, int chw, void\* stream\)", src)
    assert "<<<n, kThreads, 0, s>>>" in src and "cudaGetLastError()" in src
    assert "float4" in src and "__fmul_rn" in src and "torch/" not in src
    path, line = staging.REPLACES.split(":")
    assert (ROOT / path).read_text().splitlines()[int(line) - 1].startswith("def stage_uint8_to_tanh(")
    assert staging.PIECE == 16 and "words = chw / 4" in src
