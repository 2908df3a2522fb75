"""The arithmetic of the plain reference: every convolution, transposed
convolution and matrix product goes through one `Arith`, which computes in
float32 ("float32") or, for the control, rounds both operands of each
product, forward and backward, to TF32's 10-bit mantissa ("tf32"), as the
tensor cores do when cuBLAS and cuDNN are allowed TF32. The rounding is done
here in float32 arithmetic, so it reads the same on any device."""

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


def round_tf32(x):
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding of a product's operand; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity, whose gradient is rounded to TF32: the cotangent that
    enters a product's backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Arith:
    def __init__(self, precision="float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}; one of {PRECISIONS}")
        self.tf32 = precision == "tf32"

    def _product(self, fn, a, b, *args, **kwargs):
        if not self.tf32 or a.dtype != torch.float32:
            return fn(a, b, *args, **kwargs)
        return _RoundGrad.apply(fn(_Round.apply(a), _Round.apply(b), *args, **kwargs))

    def conv(self, x, w, stride=1, padding=0, dilation=1):
        return self._product(F.conv2d, x, w, None, stride, padding, dilation)

    def deconv(self, x, w, stride, padding, output_padding):
        return self._product(F.conv_transpose2d, x, w, None, stride, padding, output_padding)

    def matmul(self, a, b):
        return self._product(torch.matmul, a, b)
