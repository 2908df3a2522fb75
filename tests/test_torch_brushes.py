"""npe_tpu_torch's brush helpers against npe_tpu's on the same seeded
inputs, exactly: the cases of tests/test_brushes.py and seeded ones."""

import numpy as np
import pytest

from npe_tpu.editor import brushes as ref
from npe_tpu_torch.editor import brushes

GK_CASES = [((10, 20, 30, 40), 64, 0.3), ((0, 0, 64, 64), 64, 0.3), ((5, 5, 6, 6), 64, 1.5),
            ((0, 60, 3, 64), 64, 0.7), ((2, 3, 9, 11), 16, 0.5)]


def _seeded_boxes(n, seed=0):
    rng = np.random.RandomState(seed)
    cases = []
    for _ in range(n):
        c1, c2 = sorted(int(v) for v in rng.randint(0, 65, 2))
        r1, r2 = sorted(int(v) for v in rng.randint(0, 65, 2))
        cases.append(((c1, r1, c2, r2), 64, float(rng.uniform(0.1, 2.0))))
    return cases


GK_CASES += _seeded_boxes(4)


@pytest.mark.parametrize("box,im,sigma", GK_CASES)
def test_gk_equals_npe_tpu(box, im, sigma):
    got = brushes.gk(*box, im=im, sigma=sigma)
    assert got.shape == (3, im, im) and got.dtype == np.float64
    np.testing.assert_array_equal(got, ref.gk(*box, im=im, sigma=sigma))


@pytest.mark.parametrize("h", [1.0, 4.0, 0.5])
def test_upperlim_equals_npe_tpu(h):
    img = np.random.RandomState(0).randint(0, 256, size=(3, 8, 8)).astype(np.float64)
    np.testing.assert_array_equal(brushes.upperlim(img, h=h), ref.upperlim(img, h=h))
    for v in (128.0, 255.0, 0.0):
        assert brushes.upperlim(np.array([v]), h=h)[0] == ref.upperlim(np.array([v]), h=h)[0]


@pytest.mark.parametrize("thresh", [0.75, 0.2])
@pytest.mark.parametrize("seed", [1, 2])
def test_dampen_equals_npe_tpu(thresh, seed):
    rs = np.random.RandomState(seed)
    inp, cor = rs.uniform(-1, 1, size=(5, 5)), rs.uniform(-1, 1, size=(5, 5))
    np.testing.assert_array_equal(brushes.dampen(inp, cor, thresh=thresh), ref.dampen(inp, cor, thresh=thresh))
