"""Data pipeline (the port's own copy of npe_tpu `data/datasets.py`: numpy
only, the same classes and loaders, byte for byte the same data).

The reference streams CelebA 64x64 through Fuel HDF5 (`train_IAN.py:357-374`,
`:415,441`) and loads a validation .npz for the editor (`NPE.py:44`). Neither
artifact ships with the reference mount (SURVEY.md global facts), so this
module provides:

  * `NpzImageDataset` -- any (N, 3, 64, 64) uint8 .npz (e.g. a converted
    CelebA, or the editor's CelebAValid.npz);
  * `SyntheticFaces`  -- a deterministic procedural face-like dataset
    (colored blobs on gradients) so training / tests / benchmarks run
    hermetically;
  * `data_loader`     -- the reference's chunked generator contract: yields
    float32 chunks of batch_size*batches_per_chunk images in [-1, 1], with
    per-epoch seeded shuffling and the alternating half-batch offset trick
    (`train_IAN.py:436-443`).
"""

import os

import numpy as np

from npe_tpu_torch.utils.ranges import to_tanh


class SyntheticFaces:
    """Deterministic procedural 64x64 'faces': an oval skin blob, two eyes,
    a mouth, on a colored background. Enough structure for an autoencoder
    to learn, fully hermetic, seeded per index."""

    def __init__(self, num_examples=4096, size=64, seed=7):
        self.num_examples = num_examples
        self.size = size
        self.seed = seed

    def _one(self, idx):
        rng = np.random.RandomState(self.seed * 1000003 + idx)
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.zeros((3, s, s), np.float32)
        # background gradient
        bg = rng.rand(3, 2).astype(np.float32)
        for c in range(3):
            img[c] = bg[c, 0] * (1 - yy) + bg[c, 1] * yy
        # face oval
        cx, cy = 0.5 + 0.1 * (rng.rand() - 0.5), 0.5 + 0.1 * (rng.rand() - 0.5)
        rx, ry = 0.28 + 0.08 * rng.rand(), 0.36 + 0.08 * rng.rand()
        oval = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1.0
        skin = 0.55 + 0.3 * rng.rand(3).astype(np.float32)
        skin[2] *= 0.8
        for c in range(3):
            img[c] = np.where(oval, skin[c], img[c])
        # eyes
        for ex in (cx - 0.12, cx + 0.12):
            eye = ((xx - ex) / 0.045) ** 2 + ((yy - (cy - 0.08)) / 0.03) ** 2 < 1.0
            for c in range(3):
                img[c] = np.where(eye, 0.1 + 0.1 * rng.rand(), img[c])
        # mouth
        mouth = ((xx - cx) / 0.12) ** 2 + ((yy - (cy + 0.18)) / 0.035) ** 2 < 1.0
        img[0] = np.where(mouth, 0.6 + 0.3 * rng.rand(), img[0])
        img[1] = np.where(mouth, 0.2, img[1])
        img[2] = np.where(mouth, 0.25, img[2])
        return np.uint8(np.clip(img * 255, 0, 255))

    def get_data(self, indices):
        return np.stack([self._one(int(i)) for i in indices])


class RealPhotos64:
    """Real-photograph 64x64 dataset: deterministic seeded random crops
    (scale + flip jitter) from a pool of source photos. The reference trains
    on CelebA via Fuel HDF5 (`train_IAN.py:415,441`), which cannot be
    downloaded without a network -- this class provides REAL natural-image
    statistics (textures, edges, faces) from photos bundled with the Python
    distribution (matplotlib's grace_hopper portrait, sklearn's china/flower)
    or from any user-supplied directory of images (`source_dir=`), e.g. an
    unpacked CelebA.

    Crop protocol per index: pick a source photo, a scale in [0.2, 0.9] of
    the short side, a position, and a horizontal flip -- all from a
    RandomState seeded by the index, so the dataset is fully deterministic
    and random-access (get_data(indices) contract)."""

    def __init__(self, num_examples=8192, size=64, seed=11, source_dir=None):
        self.num_examples = num_examples
        self.size = size
        self.seed = seed
        self._photos = self._load_sources(source_dir)

    @staticmethod
    def _load_sources(source_dir):
        from PIL import Image

        photos = []
        if source_dir:
            import glob

            paths = sorted(
                p
                for pat in ("*.jpg", "*.jpeg", "*.png", "*.bmp")
                for p in glob.glob(os.path.join(source_dir, pat))
            )
            for p in paths:
                photos.append(np.asarray(Image.open(p).convert("RGB")))
        else:
            import matplotlib

            mpl_sample = os.path.join(matplotlib.get_data_path(), "sample_data")
            for name in ("grace_hopper.jpg",):
                p = os.path.join(mpl_sample, name)
                if os.path.isfile(p):
                    photos.append(np.asarray(Image.open(p).convert("RGB")))
            try:
                from sklearn.datasets import load_sample_images

                photos.extend(np.asarray(im, np.uint8) for im in load_sample_images().images)
            except Exception:
                pass
        if not photos:
            raise FileNotFoundError("RealPhotos64: no source photos found")
        return photos

    def _one(self, idx):
        from PIL import Image

        rng = np.random.RandomState(self.seed * 2654435761 % (2**31) + idx)
        photo = self._photos[rng.randint(len(self._photos))]
        h, w = photo.shape[:2]
        crop = int(min(h, w) * rng.uniform(0.2, 0.9))
        y0 = rng.randint(h - crop + 1)
        x0 = rng.randint(w - crop + 1)
        patch = photo[y0 : y0 + crop, x0 : x0 + crop]
        if rng.rand() < 0.5:
            patch = patch[:, ::-1]
        im = Image.fromarray(patch).resize((self.size, self.size), Image.BILINEAR)
        return np.asarray(im, np.uint8).transpose(2, 0, 1)  # CHW

    def get_data(self, indices):
        return np.stack([self._one(int(i)) for i in indices])


# Curated photographic/texture sources bundled with common Python packages
# (checked for existence at load; any subset works). The pool deliberately
# mixes subjects: a portrait, architecture, flora, outdoor/indoor scenes,
# skies, and material textures.
SYSTEM_SOURCE_FILES = [
    # matplotlib / sklearn sample photos
    "{mpl}/sample_data/grace_hopper.jpg",
    "{sk}/datasets/images/china.jpg",
    "{sk}/datasets/images/flower.jpg",
    # pygame docs: real webcam captures (outdoor brick/tree, indoor desk,
    # false-color variants with natural structure)
    "{sp}/pygame/docs/generated/_images/camera_rgb.jpg",
    "{sp}/pygame/docs/generated/_images/camera_average.jpg",
    "{sp}/pygame/docs/generated/_images/camera_hsv.jpg",
    "{sp}/pygame/docs/generated/_images/camera_yuv.jpg",
    "{sp}/pygame/docs/generated/_images/intro_freedom.jpg",
    "{sp}/pygame/docs/generated/_images/intro_blade.jpg",
    # dm_control natural-environment assets
    "{sp}/dm_control/locomotion/arenas/assets/outdoor_natural/OutdoorSkybox2048.png",
    "{sp}/dm_control/locomotion/arenas/assets/outdoor_natural/OutdoorGrassFloorD.png",
    # material textures
    "{sp}/gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/textures/white_marble_tile.png",
    "{sp}/labmaze/assets/style_02/wall_yellow_d.png",
    "{sp}/labmaze/assets/style_02/floor_blue_d.png",
    "{sp}/labmaze/assets/style_02/wall_lgreen_d.png",
    "{sp}/labmaze/assets/style_03/floor_red_d.png",
    "{sp}/labmaze/assets/style_03/wall_orange_d.png",
    "{sp}/labmaze/assets/style_03/floor_purple_d.png",
    "{sp}/labmaze/assets/sky_01/up.png",
]


def _system_source_paths():
    import sysconfig

    sp = sysconfig.get_paths()["purelib"]
    subs = {"sp": sp, "mpl": None, "sk": None}
    try:
        import matplotlib

        subs["mpl"] = matplotlib.get_data_path()
    except Exception:
        pass
    try:
        import sklearn

        subs["sk"] = os.path.dirname(sklearn.__file__)
    except Exception:
        pass
    out = []
    for pat in SYSTEM_SOURCE_FILES:
        key = pat[1 : pat.index("}")]
        if subs.get(key) is None:
            continue
        p = pat.format(**{k: v or "" for k, v in subs.items()})
        if os.path.isfile(p):
            out.append(p)
    return out


class CompositePhotos64:
    """Composite real-photo dataset: thousands of DISTINCT 64x64 source
    images, each deterministically assembled from the curated pool of real
    photographs/textures above (plus any `source_dir`). `RealPhotos64`
    draws plain crops from 3 photos -- honest but visibly
    repetitive; this generator multiplies the pool's
    diversity with photographic layering instead of more crops of the same
    pixels:

      background   -- random crop of a random source, resized to 64x64;
      0-2 subjects -- crops of OTHER sources pasted through soft elliptical
                      alpha masks at varied positions/scales (center-biased,
                      mimicking the object-on-background structure of face
                      datasets like the reference's CelebA);
      global jitter -- per-channel white-balance gains, brightness/contrast,
                      gamma, horizontal flip.

    Every texel traces back to a real image; the layout/palette/subject
    combinations are unique per index. Fully deterministic and random-access
    (the get_data contract), seeded per index."""

    def __init__(self, num_examples=65536, size=64, seed=23, source_dir=None):
        self.num_examples = num_examples
        self.size = size
        self.seed = seed
        self._photos = self._load_pool(source_dir)

    @staticmethod
    def _load_pool(source_dir):
        from PIL import Image

        paths = list(_system_source_paths())
        if source_dir:
            import glob

            paths += sorted(
                p
                for pat in ("*.jpg", "*.jpeg", "*.png", "*.bmp")
                for p in glob.glob(os.path.join(source_dir, pat))
            )
        photos = []
        for p in paths:
            try:
                photos.append(np.asarray(Image.open(p).convert("RGB")))
            except Exception:
                pass
        if not photos:
            raise FileNotFoundError("CompositePhotos64: no source photos found")
        return photos

    def _crop(self, rng, size, lo=0.15, hi=0.95):
        from PIL import Image

        photo = self._photos[rng.randint(len(self._photos))]
        h, w = photo.shape[:2]
        crop = max(8, int(min(h, w) * rng.uniform(lo, hi)))
        y0 = rng.randint(h - crop + 1)
        x0 = rng.randint(w - crop + 1)
        patch = photo[y0 : y0 + crop, x0 : x0 + crop]
        if rng.rand() < 0.5:
            patch = patch[:, ::-1]
        im = Image.fromarray(patch).resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.float32)

    @staticmethod
    def _soft_ellipse(rng, size, cx, cy, rx, ry, feather=0.12):
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        d = np.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
        return np.clip((1.0 - d) / feather, 0.0, 1.0)[..., None]

    def _one(self, idx):
        rng = np.random.RandomState((self.seed * 2654435761 + idx * 40503) % (2**31))
        s = self.size
        img = self._crop(rng, s, 0.3, 0.95)
        for _ in range(rng.randint(3)):  # 0-2 pasted subjects
            sub = self._crop(rng, s, 0.15, 0.7)
            cx = 0.5 + 0.35 * (rng.rand() - 0.5) * 2
            cy = 0.5 + 0.35 * (rng.rand() - 0.5) * 2
            rx = rng.uniform(0.15, 0.45)
            ry = rx * rng.uniform(0.7, 1.4)
            alpha = self._soft_ellipse(rng, s, cx, cy, rx, ry) * rng.uniform(0.6, 1.0)
            img = alpha * sub + (1 - alpha) * img
        gains = rng.uniform(0.8, 1.2, 3).astype(np.float32)  # white balance
        img = img * gains
        img = (img - 127.5) * rng.uniform(0.85, 1.15) + 127.5 + rng.uniform(-20, 20)
        img = 255.0 * (np.clip(img, 0, 255) / 255.0) ** rng.uniform(0.85, 1.2)
        return np.uint8(np.clip(img, 0, 255)).transpose(2, 0, 1)  # CHW

    def get_data(self, indices):
        return np.stack([self._one(int(i)) for i in indices])


class NpzImageDataset:
    """(N, 3, H, W) uint8 images from an .npz (key 'arr_0', like the
    reference's CelebAValid.npz, `NPE.py:44`)."""

    def __init__(self, path, key="arr_0"):
        self._data = np.load(path)[key]
        self.num_examples = len(self._data)

    def get_data(self, indices):
        return self._data[np.asarray(indices)]


def index_loader(cfg, num_examples, offset=0, shuffle=False, seed=42):
    """The chunking/shuffle protocol of `data_loader` (reference
    `train_IAN.py:357-374`), yielding INDEX vectors instead of data -- used
    when the whole uint8 dataset is resident in device memory and the
    per-chunk gather happens on the card (training/train.py device cache)."""
    chunk_size = cfg["batch_size"] * cfg["batches_per_chunk"]
    rng = np.random.RandomState(seed)
    n = num_examples - offset
    index = rng.permutation(n) if shuffle else np.arange(n)
    for i in range(n // chunk_size):
        yield index[chunk_size * i : chunk_size * (i + 1)] + offset


def data_loader(cfg, dataset, offset=0, shuffle=False, seed=42, raw=False):
    """Chunk generator (reference `train_IAN.py:357-374`): yields
    to_tanh(float32) arrays of shape (chunk, 3, 64, 64); with raw=True the
    chunks stay uint8 so the range conversion happens ON DEVICE
    (ops.kernels.staging.stage_chunk) and the host ships 4x fewer bytes."""
    for sel in index_loader(
        cfg, dataset.num_examples, offset=offset, shuffle=shuffle, seed=seed
    ):
        data = dataset.get_data(sel)
        yield np.uint8(data) if raw else to_tanh(np.float32(data))


class Hdf5ImageDataset:
    """Fuel-style HDF5 dataset (the reference streams CelebA via Fuel's
    `celeba_64.hdf5`, `train_IAN.py:415,441`): a `features` dataset of
    (N, 3, 64, 64) uint8, optionally windowed by a split range so
    train/valid/test subsets can be selected."""

    def __init__(self, path, source="features", start=0, stop=None):
        import h5py

        self._f = h5py.File(path, "r")
        self._d = self._f[source]
        self._start = start
        stop = stop if stop is not None else self._d.shape[0]
        self.num_examples = stop - start

    def get_data(self, indices):
        import numpy as _np

        idx = _np.asarray(indices) + self._start
        order = _np.argsort(idx)  # h5py requires increasing indices
        out = self._d[_np.sort(idx).tolist()]
        inv = _np.empty_like(order)
        inv[order] = _np.arange(len(order))
        return out[inv]


def get_dataset(spec, num_examples=4096):
    """'synthetic', 'real' (bundled-photo crops), 'real:<dir>' (crops from a
    directory of images), a path to an .npz, or an .hdf5/.h5 (Fuel CelebA
    layout); hdf5 specs accept 'file.hdf5:start:stop' split windows."""
    if spec in (None, "synthetic"):
        return SyntheticFaces(num_examples=num_examples)
    s = str(spec)
    if s == "real" or s.startswith("real:"):
        src = s[len("real:"):] or None if s.startswith("real:") else None
        return RealPhotos64(num_examples=num_examples, source_dir=src)
    if s == "composite" or s.startswith("composite:"):
        src = s[len("composite:"):] or None if s.startswith("composite:") else None
        return CompositePhotos64(num_examples=num_examples, source_dir=src)
    if ".hdf5" in s or ".h5" in s:
        parts = s.split(":")
        path = parts[0]
        start = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        stop = int(parts[2]) if len(parts) > 2 and parts[2] else None
        return Hdf5ImageDataset(path, start=start, stop=stop)
    return NpzImageDataset(s)
