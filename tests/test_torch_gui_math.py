"""npe_tpu_torch's widget-free Tk helpers against npe_tpu's on the same
inputs, exactly: the cases of tests/test_gui_math.py and seeded ones. The
module imports without a display (tkinter only inside `run`)."""

import numpy as np
import pytest

from npe_tpu.editor import gui as ref
from npe_tpu_torch.editor import gui


@pytest.mark.parametrize("rgb", [(0, 0, 0), (255, 255, 255), (255, 0, 0), (12, 200, 7)])
def test_hex_color_equals_npe_tpu(rgb):
    assert gui.hex_color(*rgb) == ref.hex_color(*rgb)


@pytest.mark.parametrize("values", [[0, 255, -255, 1000, -1000, 0.4, -0.6, 254.9],
                                    list(range(-300, 301, 3)),
                                    list(np.random.RandomState(0).uniform(-400, 400, 50))])
def test_signed_color_equals_npe_tpu(values):
    assert [gui.signed_color(v) for v in values] == [ref.signed_color(v) for v in values]


BRUSH_CASES = [(128, 128, 12, 4, 64, 64), (0, 0, 12, 4, 64, 64), (255, 255, 12, 4, 64, 64),
               (128, 128, 64, 4, 64, 64), (3, 250, 0, 4, 64, 64), (100, 7, 33, 2, 128, 96)]


@pytest.mark.parametrize("args", BRUSH_CASES)
def test_brush_box_equals_npe_tpu(args):
    assert gui.brush_box(*args) == ref.brush_box(*args)


@pytest.mark.parametrize("args", [(80, 80, 12, 2, (160, 160)), (0, 0, 12, 2, (160, 160)),
                                  (200, 200, 12, 2, (160, 160)), (30, 5, 3, 2, (64, 64)),
                                  (-20, 170, 40, 0, (160, 160))])
def test_paint_cell_bounds_equals_npe_tpu(args):
    assert gui.paint_cell_bounds(*args) == ref.paint_cell_bounds(*args)


@pytest.mark.parametrize("width,lo,hi", [(400, -255, 255), (1, -255, 255), (37, -100, 50)])
def test_gradient_swatches_equal_npe_tpu(width, lo, hi):
    assert gui.gradient_swatches(width, lo, hi) == ref.gradient_swatches(width, lo, hi)


@pytest.mark.parametrize("dim,res", [((10, 10), 16), ((4, 4), 16), ((3, 5), 8)])
def test_pool_latent_canvas_equals_npe_tpu(dim, res):
    canvas = np.random.RandomState(sum(dim)).uniform(-1, 1, (dim[0] * res, dim[1] * res)).astype(np.float32)
    got = gui.pool_latent_canvas(canvas, dim, res)
    assert got.shape == dim
    np.testing.assert_array_equal(got, ref.pool_latent_canvas(canvas, dim, res))
