"""Nonlinearities used by the reference configs (Lasagne names kept)."""

import torch
import torch.nn.functional as F


def lrelu(alpha=0.2):
    """LeakyRectify(alpha) -- reference encoder/decoder nonlinearity."""

    def f(x):
        return F.leaky_relu(x, alpha)

    return f


def relu(x):
    return F.relu(x)


def elu(x):
    return F.elu(x)


def sigmoid(x):
    return torch.sigmoid(x)
