"""Collectives over one axis of a mesh, and the context through which a
training step hands its data axis to the model code.

npe_tpu declares placement and lets GSPMD insert the communication; eager
PyTorch has to say where it goes. Each collective that carries a gradient is
a `torch.autograd.Function` built from `all_reduce` and `all_gather` only:
gloo, which the CPU runs and two ranks sharing one card need, implements
neither `reduce_scatter` nor all-to-all for CUDA tensors.

Global-batch semantics. A step over a data axis of D ranks, each holding
its B / D rows of the global batch B, computes what one process computes on
the B rows:
  * batch-norm statistics are sums over the axis (`batch_norm_apply`);
  * minibatch discrimination gathers every rank's rows (`all_gather_rows`);
  * each loss is this rank's share of the global mean (`batch_mean`: the
    local sum over the global count), so the gradients summed over the axis
    (`sum_grads`) are the global batch's; the terms of the weights alone
    enter on the axis' first rank only (`once`);
  * the metrics are those shares summed (`sum_metrics`).
The step sets the axis with `data_axis(...)` for the length of its forward
and backward; outside it (one process, a server thread, the editor) every
function computes what it computes on one device.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist


class Axis:
    """One axis of a mesh as this rank sees it: the process group of the
    ranks that differ from this one only along the axis, their number and
    this rank's index among them. An axis of size 1 has no group, and every
    collective over it is the identity."""

    def __init__(self, name, group, size, index):
        self.name, self.group, self.size, self.index = name, group, size, index

    def __repr__(self):
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the axis of x; every rank's output is the same sum, so
    the gradient of x is the sum over the axis of the outputs' gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """The axis' equal-shaped tensors concatenated along `dim`, in index
    order. Backward: with `summed`, the ranks consume the gathered tensor in
    losses that add up, so this rank's slice of the gradient is the sum over
    the axis of every rank's gradient of the gathered tensor; without it the
    ranks compute the same thing (the 'model' axis, whose ranks see the same
    rows), and each keeps its own slice."""

    @staticmethod
    def forward(ctx, x, axis, dim, summed):
        ctx.axis, ctx.dim, ctx.summed = axis, dim, summed
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        if ctx.summed:
            dist.all_reduce(g, group=ctx.axis.group)
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.index].contiguous(), None, None, None


def active(axis):
    """An axis with more than one rank: one whose collectives do anything."""
    return axis is not None and axis.size > 1


def all_reduce_sum(x, axis):
    """Sum of `x` over `axis`, differentiable; `x` itself for no axis."""
    return _AllReduceSum.apply(x, axis) if active(axis) else x


def all_gather_rows(x, axis):
    """Every rank's rows of `x` along `axis`, in index order, differentiable,
    each rank's gradient summed back to the rank that owns the rows."""
    return _AllGather.apply(x, axis, 0, True) if active(axis) else x


def gather_shards(x, axis, dim):
    """A weight that `axis` holds in equal slices along `dim`, whole again,
    differentiable: the ranks along the axis compute alike, so the backward
    keeps this rank's slice of the gradient."""
    return _AllGather.apply(x, axis, dim, False) if active(axis) else x


# --- the step's data axis -----------------------------------------------------

_DATA_AXIS = contextvars.ContextVar("npe_tpu_torch_data_axis", default=None)


@contextlib.contextmanager
def data_axis(axis):
    """For the block's length (this thread and context only), the rows of
    every batch-coupled op and loss are this rank's share of `axis`'s global
    batch. None, or an axis of size 1, is one device's semantics."""
    token = _DATA_AXIS.set(axis if active(axis) else None)
    try:
        yield
    finally:
        _DATA_AXIS.reset(token)


def current_data_axis():
    return _DATA_AXIS.get()


def batch_mean(t):
    """The mean of `t` over the global batch, or this rank's share of it:
    its sum over the global count (every rank holds as many rows). Summed
    over the data axis, the shares are the mean."""
    axis = current_data_axis()
    return t.mean() if axis is None else t.sum() / (t.numel() * axis.size)


def once(term):
    """A term of the weights alone (a penalty), counted once in the sum over
    the data axis: on its first rank, and as a zero elsewhere."""
    axis = current_data_axis()
    if axis is None or axis.index == 0:
        return term
    return torch.zeros_like(term) if isinstance(term, torch.Tensor) else 0.0


def sum_metrics(metrics):
    """{name: 0-d share} -> {name: the sum over the data axis}, in one
    all_reduce, outside autograd; the same dict when no axis is set."""
    axis = current_data_axis()
    if axis is None:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64) for k in keys])
    dist.all_reduce(flat, group=axis.group)
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def sum_grads(grad_dicts, axis):
    """Each gradient summed over `axis`, in one all_reduce per dtype (the
    dicts as they are for no axis). Returns new dicts."""
    if not active(axis):
        return grad_dicts
    entries = [(i, k, g) for i, d in enumerate(grad_dicts) for k, g in d.items()]
    out = [dict(d) for d in grad_dicts]
    for dtype in {g.dtype for _, _, g in entries}:
        same = [(i, k, g) for i, k, g in entries if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for _, _, g in same])
        dist.all_reduce(flat, group=axis.group)
        for (i, k, g), piece in zip(same, flat.split([g.numel() for _, _, g in same])):
            out[i][k] = piece.view_as(g)
    return out
