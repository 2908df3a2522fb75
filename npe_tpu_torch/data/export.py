"""Export a procedural dataset to .npz for training (npe_tpu
`data/export.py`; the reference trains from Fuel HDF5 / npz artifacts,
`train_IAN.py:415,441`, `NPE.py:44`). numpy only: the port keeps its own copy
so that it imports nothing of npe_tpu.

Train and valid splits use DIFFERENT seeds, so their crops/composites are
disjoint draws even from the same source pool.

Usage:
    python -m npe_tpu_torch.data.export --out runs/real3 \\
        --dataset composite --train 65536 --valid 2048
"""

import argparse
import os

import numpy as np


def export_split(dataset, n, path, chunk=4096):
    parts = []
    for i in range(0, n, chunk):
        parts.append(dataset.get_data(np.arange(i, min(i + chunk, n))))
    arr = np.concatenate(parts)
    assert arr.dtype == np.uint8 and arr.shape[1:] == (3, 64, 64), arr.shape
    np.savez(path, arr)
    return arr.shape


def main(argv=None):
    from npe_tpu_torch.data.datasets import CompositePhotos64, RealPhotos64, SyntheticFaces

    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--dataset", default="composite", choices=["composite", "real", "synthetic"])
    p.add_argument("--train", type=int, default=65536)
    p.add_argument("--valid", type=int, default=2048)
    p.add_argument("--train-seed", type=int, default=23)
    p.add_argument("--valid-seed", type=int, default=977)
    p.add_argument("--source-dir", default=None)
    a = p.parse_args(argv)

    os.makedirs(a.out, exist_ok=True)
    cls = {"composite": CompositePhotos64, "real": RealPhotos64, "synthetic": SyntheticFaces}[a.dataset]

    def make(n, seed):
        kw = {} if a.dataset == "synthetic" else {"source_dir": a.source_dir}
        return cls(num_examples=n, seed=seed, **kw)

    shape = export_split(make(a.train, a.train_seed), a.train, os.path.join(a.out, "train.npz"))
    print("train:", shape)
    shape = export_split(make(a.valid, a.valid_seed), a.valid, os.path.join(a.out, "valid.npz"))
    print("valid:", shape)


if __name__ == "__main__":
    main()
