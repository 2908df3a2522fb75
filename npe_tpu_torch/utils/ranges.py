"""Pixel-range helpers; work on numpy arrays and torch tensors alike."""


def to_tanh(x):
    """[0, 255] -> [-1, 1]."""
    return 2.0 * (x / 255.0) - 1.0


def from_tanh(x):
    """[-1, 1] -> [0, 255]."""
    return 255.0 * (x + 1.0) / 2.0
