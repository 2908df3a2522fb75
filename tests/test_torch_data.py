"""npe_tpu_torch's data pipeline and metrics stream against npe_tpu's: the
port keeps its own numpy-only copies, which must give the same bytes."""

import numpy as np
import pytest

from npe_tpu import data as jdata
from npe_tpu.data import datasets as jdatasets
from npe_tpu.utils import metrics_logging as jlog
from npe_tpu_torch import data as tdata
from npe_tpu_torch.data import datasets as tdatasets
from npe_tpu_torch.utils import metrics_logging as tlog

CFG = {"batch_size": 4, "batches_per_chunk": 2}


def test_the_data_package_exports_what_npe_tpu_exports():
    for name in ("NpzImageDataset", "RealPhotos64", "SyntheticFaces", "data_loader", "get_dataset"):
        assert hasattr(tdata, name) and hasattr(jdata, name)
    for name in ("CompositePhotos64", "Hdf5ImageDataset", "index_loader", "SYSTEM_SOURCE_FILES"):
        assert hasattr(tdatasets, name) and hasattr(jdatasets, name)
    assert tdatasets.SYSTEM_SOURCE_FILES == jdatasets.SYSTEM_SOURCE_FILES


@pytest.mark.parametrize("size", [64, 16])
def test_synthetic_faces_byte_equal(size):
    a, b = tdata.SyntheticFaces(40, size=size), jdata.SyntheticFaces(40, size=size)
    idx = [0, 3, 39, 3]
    np.testing.assert_array_equal(a.get_data(idx), b.get_data(idx))
    assert a.get_data(idx).dtype == np.uint8 and a.get_data(idx).shape == (4, 3, size, size)
    assert a.num_examples == b.num_examples == 40


@pytest.mark.parametrize("kind", ["real", "composite"])
def test_photo_datasets_byte_equal(kind, tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (90 + 10 * i, 120, 3), dtype=np.uint8)).save(tmp_path / f"p{i}.png")
    spec = f"{kind}:{tmp_path}"
    a, b = tdata.get_dataset(spec, num_examples=12), jdata.get_dataset(spec, num_examples=12)
    assert type(a).__name__ == type(b).__name__
    np.testing.assert_array_equal(a.get_data([0, 5, 11]), b.get_data([0, 5, 11]))


def test_npz_and_hdf5_datasets_byte_equal(tmp_path):
    h5py = pytest.importorskip("h5py")
    data = np.random.RandomState(1).randint(0, 256, (20, 3, 64, 64), dtype=np.uint8)
    np.savez(tmp_path / "d.npz", data)
    with h5py.File(tmp_path / "d.hdf5", "w") as f:
        f.create_dataset("features", data=data)
    idx = [7, 2, 19]
    for spec in (str(tmp_path / "d.npz"), str(tmp_path / "d.hdf5"), f"{tmp_path / 'd.hdf5'}:5:15"):
        a, b = tdata.get_dataset(spec), jdata.get_dataset(spec)
        assert type(a).__name__ == type(b).__name__ and a.num_examples == b.num_examples
        sel = [i % a.num_examples for i in idx]
        np.testing.assert_array_equal(a.get_data(sel), b.get_data(sel))


@pytest.mark.parametrize("offset,shuffle,seed", [(0, False, 42), (2, True, 3), (2, True, 4)])
def test_index_loader_and_data_loader_match(offset, shuffle, seed):
    ds_t, ds_j = tdata.SyntheticFaces(30, size=16), jdata.SyntheticFaces(30, size=16)
    kw = dict(offset=offset, shuffle=shuffle, seed=seed)
    idx_t, idx_j = list(tdata.index_loader(CFG, 30, **kw)), list(jdatasets.index_loader(CFG, 30, **kw))
    assert len(idx_t) == len(idx_j) == (30 - offset) // 8
    for a, b in zip(idx_t, idx_j):
        np.testing.assert_array_equal(a, b)
    for raw in (False, True):
        chunks_t = list(tdata.data_loader(CFG, ds_t, raw=raw, **kw))
        chunks_j = list(jdata.data_loader(CFG, ds_j, raw=raw, **kw))
        assert len(chunks_t) == len(chunks_j) == len(idx_t)
        for a, b, sel in zip(chunks_t, chunks_j, idx_t):
            assert a.dtype == b.dtype == (np.uint8 if raw else np.float32)
            np.testing.assert_array_equal(a, b)
            if raw:
                np.testing.assert_array_equal(a, ds_t.get_data(sel))


def test_get_dataset_specs():
    assert isinstance(tdata.get_dataset("synthetic", num_examples=5), tdata.SyntheticFaces)
    assert tdata.get_dataset(None, num_examples=5).num_examples == 5


def test_metrics_logger_matches_npe_tpu(tmp_path, capsys):
    paths = [tmp_path / "t.jsonl", tmp_path / "j.jsonl"]
    for mod, path in zip((tlog, jlog), paths):
        log = mod.MetricsLogger(str(path), reinitialize=True)
        log.log(epoch=0, itr=2, metrics={"a": 1.5})
        log.log({"note": "x"}, epoch=1)
        with open(path, "a") as fh:
            fh.write('{"torn": ')  # a crashed writer's tail
        mod.MetricsLogger(str(path), reinitialize=False).log(epoch=2)
    recs = [mod.read_records(str(path)) for mod, path in zip((tlog, jlog), paths)]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "_stamp"} for r in rs]  # noqa: E731
    assert strip(recs[0]) == strip(recs[1]) == [{"epoch": 0, "itr": 2, "metrics": {"a": 1.5}},
                                               {"note": "x", "epoch": 1}]
    assert all("_stamp" in r for r in recs[0])
    tlog.MetricsLogger(str(paths[0]), reinitialize=True)
    assert not paths[0].exists()
