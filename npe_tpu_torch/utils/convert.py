"""Theano / Lasagne checkpoint converter: the port's own copy of npe_tpu's
`utils/convert.py`. The layout changes are numpy; the file is npe_tpu's
format (`utils/checkpoints.save_arrays`), which the port loads
(`utils/checkpoints.load_weights`).

The reference saves name-keyed .npz checkpoints (`GANcheckpoints.py:11-30`)
with Lasagne parameter names ('enc_conv1.W', 'bnorm2.beta', 'dec_conv2aW',
...). Into npe_tpu's layouts:

  * forward-conv W:  OIHW -> HWIO           (transpose 2, 3, 1, 0)
  * deconv W:        (Cin, Cout, kh, kw) -> (kh, kw, Cin, Cout)
                     (reference DeconvLayer.get_W_shape, `layers.py:449-452`)
  * enc_fc1.W:       input rows permuted from the NCHW flatten (C, H, W) to
                     the NHWC flatten (H, W, C)
  * everything else: copied as it is (dense, BN, minibatch, MADE).

MADE masks are not in reference checkpoints (they are not trainable); the
connectivity rule regenerates them from an ordering (`ops/made.py`).

CLI: python -m npe_tpu_torch.utils.convert <theano.npz> <out.npz> [--reverse]
"""

import logging
import pickle

import numpy as np

logger = logging.getLogger(__name__)

DECONV_NAMES = ("dec_conv1.W", "dec_conv2.W", "dec_conv3.W", "dec_conv4.W", "dec_out.W")
FC1_SPATIAL = (1024, 4, 4)  # enc_conv4's output, NCHW


def convert_param(name, arr):
    arr = np.asarray(arr)
    if name in DECONV_NAMES and arr.ndim == 4:
        return arr.transpose(2, 3, 0, 1)
    if arr.ndim == 4 and name.endswith("W"):
        # forward conv (enc_conv*.W) and the MDCL shared filters (*W)
        return arr.transpose(2, 3, 1, 0)
    if name == "enc_fc1.W":
        c, h, w = FC1_SPATIAL
        return arr.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(c * h * w, -1)
    return arr


def convert_param_to_theano(name, arr):
    """Inverse of `convert_param`: npe_tpu's layout back to the reference's."""
    arr = np.asarray(arr)
    if name in DECONV_NAMES and arr.ndim == 4:
        return arr.transpose(2, 3, 0, 1)  # (kh, kw, cin, cout) -> (cin, cout, kh, kw)
    if arr.ndim == 4 and name.endswith("W"):
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if name == "enc_fc1.W":
        c, h, w = FC1_SPATIAL
        return arr.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(c * h * w, -1)
    return arr


def convert_to_theano_npz(variables, dst_path, metadata=None):
    """Export npe_tpu-layout variables (name -> array) to a reference-layout
    checkpoint."""
    from npe_tpu_torch.utils.checkpoints import save_arrays

    out = {k: convert_param_to_theano(k, v) for k, v in variables.items()}
    save_arrays(dst_path, out, metadata)
    return out


def _reference_metadata(raw, src_path):
    """The reference pickles its metadata under 'metadata'
    (`GANcheckpoints.py:19`), from Python 2 (cPickle of a dict holding
    np.float32, `train_IAN.py:571`): such pickles need encoding='latin1',
    which reads Python 3 pickles of plain dicts too. A metadata that does
    not unpickle to a dict is dropped with a warning."""
    try:
        item = raw.item() if hasattr(raw, "item") else raw
        meta = pickle.loads(item, encoding="latin1") if isinstance(item, bytes) else item
        if not isinstance(meta, dict):
            logger.warning("%s: metadata unpickled to %s, not dict; dropping it", src_path, type(meta).__name__)
            return {}
        return meta
    except Exception as e:
        logger.warning("%s: could not unpickle reference metadata (%s); converting without "
                       "epoch/itr/learning_rate/made_orderings", src_path, e)
        return {}


def convert_theano_npz(src_path, dst_path, metadata=None):
    """Convert a reference checkpoint file to npe_tpu's layout and format."""
    from npe_tpu_torch.utils.checkpoints import METADATA_KEY, save_arrays

    with np.load(src_path, allow_pickle=True) as f:
        stored = {k: f[k] for k in f.files}
    meta = _reference_metadata(stored.pop("metadata"), src_path) if "metadata" in stored else {}
    converted = {k: convert_param(k, v) for k, v in stored.items() if k != METADATA_KEY}
    save_arrays(dst_path, converted, metadata or meta)
    return converted


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--reverse", action="store_true", help="npe_tpu layout -> Theano layout")
    a = p.parse_args(argv)
    if a.reverse:
        with np.load(a.src, allow_pickle=False) as f:
            variables = {k: f[k] for k in f.files if k != "__metadata__"}
        convert_to_theano_npz(variables, a.dst)
    else:
        convert_theano_npz(a.src, a.dst)
    print(f"wrote {a.dst}")


if __name__ == "__main__":
    main()
