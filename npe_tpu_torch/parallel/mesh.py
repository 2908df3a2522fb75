"""The ('data', 'model') mesh and its sharding rules (npe_tpu
`parallel/mesh.py`), over torch.distributed.

Ranks form a (D, M) grid, rank = d * M + m, as npe_tpu reshapes its device
list. Along 'data' the ranks hold disjoint rows of every batch, and the
step's collectives make them compute the global batch's step exactly
(`collectives.py`). Along 'model' the weights that `param_spec` names are
held in equal slices, as are their Adam moments; a step or a forward
gathers each such weight before use and its backward keeps this rank's
slice of the gradient (FSDP's formulation: the ranks of one data index
compute the same activations, so 'model' saves the memory of parameters
and moments, not compute). The numbers equal one process's either way.

Which variables are held in slices, and along which dimension, is a
layout, {name: dimension}: `shard_layout` computes it from the full
variables, `param_spec` and the 'model' axis's size, and the caller passes it
to every function that shards or gathers (npe_tpu's arrays carry their own
sharding; a torch tensor does not). A mesh holds only its axes.

Without a process group a mesh is a world of one, (1, 1), with no groups,
as npe_tpu's `make_mesh()` on one device: every function here is then the
identity.
"""

import numpy as np
import torch
import torch.distributed as dist

from npe_tpu_torch.parallel.collectives import Axis, gather_shards
from npe_tpu_torch.utils.checkpoints import is_deconv


# npe_tpu's thresholds: outputs of a conv / MDCL / deconv kernel, and of a dense kernel
CONV_MIN, DENSE_MIN = 512, 4096


class Mesh:
    """This rank's view of a (D, M) mesh: its global rank, its device, and
    its 'data' and 'model' axes."""

    axis_names = ("data", "model")

    def __init__(self, shape, rank, device, data, model):
        self.shape, self.rank, self.device, self.data, self.model = tuple(shape), rank, device, data, model

    @property
    def size(self):
        return self.shape[0] * self.shape[1]

    def __repr__(self):
        return f"Mesh(shape={self.shape}, device={self.device}, {self.data}, {self.model})"


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(shape=None, devices=None):
    """Build the ('data', 'model') mesh over the world's ranks. Default: every
    rank on 'data'. `devices`: each rank's device, in rank order (default:
    every rank on its current CUDA device). A shape or a device list that
    does not match the world size raises. Every rank must call this, in the
    same order as any other group it makes: it creates the axes' groups."""
    world, rank = _world()
    if shape is None:
        shape = (world, 1)
    if devices is None:
        devices = [torch.device("cuda")] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a world of {world} ranks: pass one device per rank")
    if shape[0] * shape[1] != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {shape[0] * shape[1]} ranks but the world has {world}; pass a "
            f"matching shape= or start {shape[0] * shape[1]} processes (torchrun --nproc-per-node, or "
            f"parallel.multihost --num-processes)"
        )
    d_size, m_size = shape
    d_index, m_index = divmod(rank, m_size)
    groups = {"data": None, "model": None}
    # every rank creates every group, in one order (torch.distributed.new_group's rule)
    if d_size > 1:
        for m in range(m_size):
            g = dist.new_group([d * m_size + m for d in range(d_size)])
            if m == m_index:
                groups["data"] = g
    if m_size > 1:
        for d in range(d_size):
            g = dist.new_group([d * m_size + m for m in range(m_size)])
            if d == d_index:
                groups["model"] = g
    return Mesh(shape, rank, torch.device(devices[rank]), Axis("data", groups["data"], d_size, d_index),
                Axis("model", groups["model"], m_size, m_index))


def param_spec(name, value):
    """The partition spec of a variable, in the port's layouts: a tuple with
    'model' at the dimension held in slices, or () for a replicated one.
    npe_tpu's rule: the output channels of conv and MDCL kernels
    (cout, cin, kh, kw: axis 0) and of deconv kernels (cin, cout, kh, kw:
    axis 1) at CONV_MIN outputs or more; the outputs of a dense `.W` at
    DENSE_MIN or more; the kernels axis of `minibatch_discrim.theta`
    (F, K, D). The MDCL coefficient vectors and everything else stay
    replicated."""
    shape = tuple(value.shape)
    if name.endswith("W") and len(shape) == 4:
        axis = 1 if is_deconv(name) else 0
        return tuple("model" if i == axis else None for i in range(4)) if shape[axis] >= CONV_MIN else ()
    if name.endswith(".W") and len(shape) == 2 and shape[1] >= DENSE_MIN:
        return (None, "model")
    if name.endswith("minibatch_discrim.theta"):
        return (None, "model", None)
    return ()


def spec_axis(spec):
    return spec.index("model") if "model" in spec else None


def shard_layout(variables, mesh):
    """The layout of `variables` (full arrays, name -> tensor) on `mesh`:
    {name: the dimension held in 'model' slices} for each variable
    `param_spec` names, a pure function of the names, the shapes and the
    'model' axis's size; {} on a 'model' axis of one rank. A dimension that
    does not split into equal slices raises."""
    if mesh is None or mesh.model.size == 1:
        return {}
    layout = {}
    for k, v in variables.items():
        axis = spec_axis(param_spec(k, v))
        if axis is None:
            continue
        if v.shape[axis] % mesh.model.size:
            raise ValueError(f"{k}: dimension {axis} of {tuple(v.shape)} does not split into "
                             f"{mesh.model.size} equal slices")
        layout[k] = axis
    return layout


def state_layout(state, mesh):
    """`shard_layout` of a whole train state's variables (its moments share
    their parameters' names)."""
    return shard_layout({k: v for vs in state["parts"].values() for k, v in vs.items()}, mesh)


def shard_variables(variables, mesh, layout):
    """This rank's share of `variables` (full arrays, the same on every
    rank) on the mesh's device: the 'model' slice of each variable that
    `layout` names, the rest whole."""
    out = {}
    for k, v in variables.items():
        if k in layout:
            v = v.chunk(mesh.model.size, layout[k])[mesh.model.index]
        out[k] = v.to(mesh.device).contiguous()
    return out


def unshard_variables(shards, mesh, layout):
    """The whole variables from this rank's shares, differentiable in the
    shares (`collectives.gather_shards`); the same dict when `layout` is
    empty or None. Every rank of the 'model' axis must call it with the same
    names, in the same order."""
    if not layout:
        return shards
    return {k: gather_shards(v, mesh.model, layout[k]) if k in layout else v for k, v in shards.items()}


def _opt_like(opt, fn):
    return {"count": opt["count"], "mu": fn(opt["mu"]), "nu": fn(opt["nu"])}


def shard_train_state(state, mesh, layout):
    """A train state (`training.train_step`'s nested dict) as this rank
    holds it: variables by `layout` (`state_layout`), Adam moments like
    their parameters, counts and `step` replicated, all on the mesh's
    device."""
    to_mesh = lambda d: shard_variables(d, mesh, layout)  # noqa: E731
    return {"parts": {p: to_mesh(vs) for p, vs in state["parts"].items()},
            "opt": {p: {**_opt_like(o, to_mesh), "count": o["count"].to(mesh.device)} for p, o in state["opt"].items()},
            "step": state["step"].to(mesh.device)}


def gather_train_state(state, mesh, layout):
    """The whole train state from this rank's shares (for a checkpoint):
    every rank of the 'model' axis must call it."""
    if not layout:
        return state
    with torch.no_grad():
        full = lambda d: unshard_variables(d, mesh, layout)  # noqa: E731
        return {"parts": {p: full(vs) for p, vs in state["parts"].items()},
                "opt": {p: _opt_like(o, full) for p, o in state["opt"].items()},
                "step": state["step"]}


def gather_variables(shards, mesh, layout):
    with torch.no_grad():
        return unshard_variables(shards, mesh, layout)


def broadcast_from_first(array, mesh):
    """Rank 0's numpy array on every rank of the mesh (the same shape and
    dtype everywhere); the array itself on a world of one."""
    if mesh is None or mesh.size == 1:
        return array
    t = torch.from_numpy(np.ascontiguousarray(array)).to(mesh.device)
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def batch_rows(n, mesh):
    """The rows [lo, hi) of a global batch of n that this rank holds."""
    d = mesh.data.size if mesh is not None else 1
    if n % d:
        raise ValueError(f"a global batch of {n} does not split over {d} data ranks")
    i = mesh.data.index if mesh is not None else 0
    return i * (n // d), (i + 1) * (n // d)


def shard_batch(x, mesh):
    """This rank's rows of the global batch `x` (its leading axis split over
    'data'), on the mesh's device."""
    lo, hi = batch_rows(x.shape[0], mesh)
    return x[lo:hi].to(mesh.device)
