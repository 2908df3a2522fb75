"""The port's ctypes binding of the native C++ chunk loader
(`npe_tpu_torch/data/native_loader.py` over `native/loader.cpp`): the cases of
`tests/test_native_loader.py`, the same chunk order as npe_tpu's binding for
the same seed, where it builds, and that it raises when it cannot build."""

import os

import numpy as np
import pytest

from npe_tpu_torch.data import SyntheticFaces
from npe_tpu_torch.data import native_loader as nl


@pytest.fixture(scope="module")
def raw_dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("raw") / "train.raw"
    ds = SyntheticFaces(num_examples=64, size=16)
    num, shape = nl.export_raw(ds, str(path))
    return str(path), num, shape, ds


def test_export_raw_writes_the_records_and_the_count_reads_back(raw_dataset):
    path, num, shape, ds = raw_dataset
    assert (num, shape) == (64, (3, 16, 16))
    assert nl.num_records(path, shape) == 64
    np.testing.assert_array_equal(np.fromfile(path, np.uint8).reshape(64, *shape), ds.get_data(list(range(64))))


def test_the_library_builds_into_the_port_build_directory(raw_dataset):
    nl.get_lib()
    so = nl.library_path()
    assert os.path.isfile(so) and os.path.dirname(so) == nl.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    assert os.path.dirname(nl.BUILD_DIR).endswith("npe_tpu_torch")


def test_stream_matches_records(raw_dataset):
    path, num, shape, ds = raw_dataset
    ld = nl.NativeChunkLoader(path, num, shape, chunk_records=16)
    chunks = list(ld.epoch(shuffle=False, seed=0, offset=0))
    assert len(chunks) == 4
    np.testing.assert_array_equal(np.concatenate(chunks), ds.get_data(list(range(64))))
    ld.close()


def test_shuffle_deterministic_and_complete(raw_dataset):
    path, num, shape, ds = raw_dataset
    ld = nl.NativeChunkLoader(path, num, shape, chunk_records=16)
    a = np.concatenate(list(ld.epoch(shuffle=True, seed=7)))
    b = np.concatenate(list(ld.epoch(shuffle=True, seed=7)))
    c = np.concatenate(list(ld.epoch(shuffle=True, seed=8)))
    np.testing.assert_array_equal(a, b)  # same seed -> same order
    assert not np.array_equal(a, c)  # different seed -> different order
    expect = ds.get_data(list(range(64)))
    assert sorted(x.tobytes() for x in a) == sorted(x.tobytes() for x in expect)
    ld.close()


def test_offset_window(raw_dataset):
    path, num, shape, ds = raw_dataset
    ld = nl.NativeChunkLoader(path, num, shape, chunk_records=16)
    chunks = list(ld.epoch(shuffle=False, seed=0, offset=4))
    np.testing.assert_array_equal(chunks[0], ds.get_data(list(range(4, 20))))
    assert len(chunks) == 3  # 60 records in the window: three whole chunks of 16
    ld.close()


@pytest.mark.parametrize("raw", [False, True])
def test_chunk_loader_generator(raw_dataset, raw):
    path, num, shape, _ = raw_dataset
    cfg = {"batch_size": 8, "batches_per_chunk": 2}
    out = list(nl.native_chunk_loader(cfg, path, num, shape, shuffle=True, seed=1, raw=raw))
    assert len(out) == 4 and out[0].shape == (16, *shape)
    if raw:
        assert out[0].dtype == np.uint8
    else:
        assert out[0].dtype == np.float32 and out[0].min() >= -1 and out[0].max() <= 1


@pytest.mark.parametrize("shuffle, seed, offset", [(True, 3, 0), (True, 11, 4), (False, 0, 8)])
def test_chunk_order_equals_npe_tpu_for_the_same_seed(raw_dataset, shuffle, seed, offset):
    from npe_tpu.data.native_loader import native_chunk_loader as jax_loader

    path, num, shape, _ = raw_dataset
    cfg = {"batch_size": 8, "batches_per_chunk": 2}
    kw = dict(shuffle=shuffle, seed=seed, offset=offset, raw=True)
    got = list(nl.native_chunk_loader(cfg, path, num, shape, **kw))
    want = list(jax_loader(cfg, path, num, shape, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_loader_over_a_short_file_raises(tmp_path):
    path = tmp_path / "short.raw"
    path.write_bytes(bytes(100))
    with pytest.raises(OSError, match="npe_loader_open failed"):
        nl.NativeChunkLoader(str(path), 4, (3, 16, 16), chunk_records=2)


def test_no_compiler_means_no_loader(monkeypatch, tmp_path):
    monkeypatch.setattr(nl, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        nl.get_lib()
    assert not (tmp_path / "_build").exists()
