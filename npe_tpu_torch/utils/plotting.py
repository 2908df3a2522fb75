"""Image-grid plotting (reference `discgen_utils.py:11-41`, itself from
discgen): rows x cols grid of CHW uint8/float images saved via the Agg
backend, axes off, dpi 212."""

import numpy as np


def plot_image_grid(images, num_rows, num_cols, save_path=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import ImageGrid

    figure = plt.figure()
    grid = ImageGrid(figure, 111, (num_rows, num_cols), axes_pad=0.1)
    for image, axis in zip(images, grid):
        axis.imshow(np.asarray(image).transpose(1, 2, 0), interpolation="nearest")
        axis.axis("off")
    if save_path is None:
        plt.show()
    else:
        plt.savefig(save_path, dpi=212, transparent=False, bbox_inches="tight")
    plt.close(figure)
