"""Image grids (reference `discgen_utils.py:11-41`, itself from discgen): a
rows x cols grid of CHW uint8 images, written as a PNG by `utils/png.py`, so
that the trainer's and the sampler's grids need no imaging or plotting
package (the card's machine has neither PIL nor matplotlib). The reference
drew the grid with matplotlib's ImageGrid; this tiles the pixels as they are,
each image at its own size, on a white ground."""

import numpy as np

from npe_tpu_torch.utils.png import encode_rgb

PAD = 2  # white pixels between two images


def grid_image(images, num_rows, num_cols):
    """(N, 3, H, W) uint8 images, N <= rows * cols, row-major -> one
    (rows*(H+PAD)-PAD, cols*(W+PAD)-PAD, 3) uint8 picture."""
    images = np.asarray(images)
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"grid_image wants (N, 3, H, W) uint8 images, got {images.dtype} {images.shape}")
    if len(images) > num_rows * num_cols:
        raise ValueError(f"{len(images)} images do not fit a {num_rows}x{num_cols} grid")
    h, w = images.shape[2:]
    out = np.full((num_rows * (h + PAD) - PAD, num_cols * (w + PAD) - PAD, 3), 255, np.uint8)
    for i, image in enumerate(images):
        r, c = divmod(i, num_cols)
        out[r * (h + PAD): r * (h + PAD) + h, c * (w + PAD): c * (w + PAD) + w] = image.transpose(1, 2, 0)
    return out


def plot_image_grid(images, num_rows, num_cols, save_path):
    """Write the grid of `images` to `save_path` as a PNG."""
    with open(save_path, "wb") as f:
        f.write(encode_rgb(grid_image(images, num_rows, num_cols)))
