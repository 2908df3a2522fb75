"""The numbers that decide `correct`, and the seeded sample of a window's
answers that the reference follows."""

import math

import numpy as np
import torch


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def abs_gap(got, want):
    """The widest gap, max |got - want|."""
    got, want = _t(got).double(), _t(want).double().to(_t(got).device)
    return float((got - want).abs().max())


def rel_gap(got, want):
    """The widest gap over the largest value of `want`."""
    want = _t(want).double()
    return abs_gap(got, want) / max(float(want.abs().max()), 1e-30)


def leaf_norm_gaps(got, want):
    """Leaf by leaf, | ||got[k]|| - ||want[k]|| | over the larger of
    ||want[k]|| and the median leaf's ||want|| (the gap of the norms, not the
    norm of the difference); returns ({leaf: gap}, {leaf: ||want[k]||})."""
    norms = {k: float(t.double().norm()) for k, t in want.items()}
    floor = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].double().norm()) - n) / max(n, floor, 1e-30) for k, n in norms.items()}, norms


def worst(gaps):
    """(the largest gap, its leaf); a leaf that is not finite is the worst."""
    which = max(gaps, key=lambda k: gaps[k] if math.isfinite(gaps[k]) else math.inf)
    return gaps[which], which


class Reservoir:
    """A uniform sample of `k` of the items offered, drawn from `seed`
    (Algorithm R): the window decides how many it offers, and every one has
    the same chance to be in the sample. `draw` alone says which slot the
    next item goes into, for a caller that copies it into a slot of its own."""

    def __init__(self, k, seed):
        self.k, self.n, self.items = int(k), 0, []
        self.rng = np.random.default_rng(seed)

    def draw(self):
        """The slot of the sample that the next item offered goes into, or
        None when it is not kept."""
        self.n += 1
        if self.n <= self.k:
            return self.n - 1
        j = int(self.rng.integers(0, self.n))
        return j if j < self.k else None

    def put(self, j, item):
        if j == len(self.items):
            self.items.append(item)
        else:
            self.items[j] = item

    def offer(self, item):
        j = self.draw()
        if j is not None:
            self.put(j, item)
