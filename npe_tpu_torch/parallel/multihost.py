"""Multi-process data parallelism over torch.distributed (npe_tpu
`parallel/multihost.py`).

npe_tpu starts `jax.distributed` and builds one global mesh over every
process's devices; here each process is one rank, with one device, and
`init_multihost` starts the process group and returns the ('data', 'model')
mesh (`mesh.py`). Every rank computes the same global batch from a seed and
feeds only its own rows; the step's collectives (`collectives.py`) make the
ranks compute one process's step on the global batch.

Backends: NCCL between cards, gloo on the CPU. Two ranks on ONE card need
gloo too (NCCL refuses two ranks on one device): `backend="gloo"` with
`device="cuda"` is the counterpart of npe_tpu's `--local-devices` CPU mode,
with both ranks' tensors on the card and gloo staging them through the host.

Entry points:
  init_multihost(coordinator, num_processes, process_id, device, mesh_shape)
      -- the process group (with a setup timeout: a missing peer fails the
         run) and the mesh.
  put_replicated(value, mesh) / put_batch(global_batch, mesh)
      -- a value every rank holds whole, or this rank's rows of it, on the
         mesh's device.
  shard_train_state_multihost(state, mesh, layout) -- mesh.py's sharding.
  demo_step(mesh, batch_size, config, seed) -- one G and one D step.

Demo (rank 0 prints MULTIHOST_METRICS lines):
  python -m npe_tpu_torch.parallel.multihost --coordinator 127.0.0.1:29500 \\
      --num-processes 2 --process-id $i [--device cpu] [--backend gloo] \\
      [--mesh 2 1] --config IAN_simple --batch-size 16
"""

import argparse
import datetime
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from npe_tpu_torch.parallel.collectives import all_gather_rows
from npe_tpu_torch.parallel.mesh import (
    batch_rows, gather_train_state, gather_variables, make_mesh, shard_batch, shard_layout, shard_train_state,
    shard_variables, state_layout,
)
from npe_tpu_torch.utils.device import resolve_device

SETUP_TIMEOUT_S = 300
INFER_BATCH = 64  # the global batch of the demo's sharded encode + decode


def init_multihost(coordinator, num_processes, process_id, device="cuda", mesh_shape=None, backend=None,
                   timeout_s=SETUP_TIMEOUT_S):
    """Start this rank's process group and return the global mesh (default
    every rank on 'data'). `coordinator`: "host:port" of rank 0's store, or
    an init-method URL ("file:///path", "tcp://host:port", "env://" under
    torchrun). `device` "cuda" puts rank i on card i mod the host's card
    count (torchrun's local rank, on hosts of equal card counts); the
    backend defaults to NCCL there and to gloo on the CPU. Setup, and every
    later collective, fails after `timeout_s` seconds instead of waiting for
    a missing peer."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {"device_id": device} if backend == "nccl" else {}  # NCCL binds the rank to its card
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return make_mesh(mesh_shape or (num_processes, 1), devices=[device] * num_processes)


def put_replicated(value, mesh):
    """A value every rank holds whole, as a tensor on the mesh's device."""
    return torch.as_tensor(np.asarray(value)).to(mesh.device)


def put_batch(global_batch, mesh):
    """This rank's rows of a batch every rank knows whole (its leading axis
    split over 'data'), on the mesh's device."""
    return shard_batch(torch.as_tensor(np.asarray(global_batch)), mesh)


def shard_train_state_multihost(state, mesh, layout):
    """mesh.py's sharding: each rank holds its own shares, so the
    single-process and the multi-process paths are one function here."""
    return shard_train_state(state, mesh, layout)


def _barrier(mesh):
    if mesh is not None and mesh.size > 1:
        dist.barrier()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def global_batch(batch_size, num_latents, seed):
    """(uint8 images (N, 3, 64, 64), z_rand, noise), the same on every rank:
    procedural faces and normals drawn from a numpy seed."""
    from npe_tpu_torch.data import SyntheticFaces

    rng = np.random.RandomState(seed)
    faces = SyntheticFaces(max(256, batch_size)).get_data(rng.choice(max(256, batch_size), batch_size,
                                                                     replace=False))
    z, eps = (rng.randn(batch_size, num_latents).astype(np.float32) for _ in range(2))
    return np.uint8(faces), z, eps


def _kernel_counts():
    from npe_tpu_torch.ops.kernels import rgb_beta_tail, staging

    return {"staging": staging.stage_chunk.launches, "rgb_beta_tail": rgb_beta_tail.rgb_beta_tail.launches}


def _zero_kernel_counts():
    from npe_tpu_torch.ops.kernels import rgb_beta_tail, staging

    staging.stage_chunk.launches = 0
    rgb_beta_tail.rgb_beta_tail.launches = 0


def run_demo(mesh, batch_size=16, config="IAN_simple", seed=0, repeats=0, device="cuda"):
    """`demo_step`'s work, with what the demo CLI reports: {"gen": the G
    step's metrics, "discrim": the D step's, "launches": this rank's kernel
    launches in those two steps and the staging of its rows, "mu": the
    whole Adam first moments after them ({part: {name: CPU tensor}}, the
    summed gradients' trace), "state_sha256": a digest of the whole state
    after them (the same on every rank when the replicas agree bit for
    bit), "ms_per_g_and_d_step": the mean wall time of `repeats` more G + D
    pairs (None without)}. `mesh` None is one process on `device`."""
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.ops.kernels.staging import stage_chunk
    from npe_tpu_torch.training import train_step as TS

    device = mesh.device if mesh is not None else resolve_device(device)
    module = get_config(config)
    cfg = dict(module.cfg, batch_size=batch_size)
    variables = module.init(torch.Generator().manual_seed(seed), device)
    state = TS.init_train_state(module, variables, cfg)
    layout = state_layout(state, mesh)
    if mesh is not None:
        state = shard_train_state_multihost(state, mesh, layout)
    gen_step, discrim_step = TS.make_train_steps(module, cfg, mesh=mesh, layout=layout)
    images, z, eps = global_batch(batch_size, cfg["num_latents"], seed + 1)
    lo, hi = batch_rows(batch_size, mesh)
    # every rank holds the global batch's bytes and stages its own rows
    u8 = torch.from_numpy(images).to(device)
    z, eps = (torch.from_numpy(a[lo:hi]).to(device) for a in (z, eps))
    _barrier(mesh)  # the peers' groups are up before the first collective inside a step
    _zero_kernel_counts()
    x = stage_chunk(u8, np.arange(lo, hi))
    state, m_g = gen_step(state, x, z, eps, 2e-4)
    state, m_d = discrim_step(state, x, z, eps, 2e-4)
    _sync(device)
    launches = _kernel_counts()
    whole = gather_train_state(state, mesh, layout)
    mu = {p: {k: t.cpu() for k, t in o["mu"].items()} for p, o in whole["opt"].items()}
    ms = None
    if repeats:
        _barrier(mesh)
        t0 = time.perf_counter()
        for _ in range(repeats):
            state, _ = gen_step(state, x, z, eps, 2e-4)
            state, _ = discrim_step(state, x, z, eps, 2e-4)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3 / repeats
    return {"gen": {k: float(v) for k, v in m_g.items()}, "discrim": {k: float(v) for k, v in m_d.items()},
            "launches": launches, "mu": mu, "state_sha256": state_digest(whole), "ms_per_g_and_d_step": ms}


def state_digest(state):
    """sha256 of a train state's tensors' bytes, in name order."""
    h = hashlib.sha256()
    for path, t in sorted(_leaves(state)):
        h.update(path.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def demo_step(mesh, batch_size=16, config="IAN_simple", seed=0, device="cuda"):
    """One G step and one D step of `config`, data-parallel over the mesh:
    every rank builds the same global batch from `seed`, stages its own rows
    and steps. Returns {metric: float}, the same on every rank: as npe_tpu's,
    the G step's metrics updated with the D step's."""
    out = run_demo(mesh, batch_size, config, seed, device=device)
    return {**out["gen"], **out["discrim"]}


def demo_infer(mesh, batch_size=INFER_BATCH, config="IAN_simple", seed=0):
    """decode(encode(x)) of a seeded global batch with the variables held as
    `shard_variables` holds them by `param_spec` (weights gathered before
    use), each rank on its rows; returns (images in [-1, 1] (N, 3, 64, 64),
    the output for all N rows, the layout) on every rank, the arrays as
    numpy."""
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.ops.kernels.staging import stage_chunk

    module = get_config(config)
    variables = module.init(torch.Generator().manual_seed(seed), mesh.device)
    layout = shard_layout(variables, mesh)
    shards = shard_variables(variables, mesh, layout)
    images, _, _ = global_batch(batch_size, module.cfg["num_latents"], seed + 1)
    lo, hi = batch_rows(batch_size, mesh)
    x = stage_chunk(torch.from_numpy(images).to(mesh.device), np.arange(lo, hi))
    with torch.no_grad():
        v = gather_variables(shards, mesh, layout)
        y = all_gather_rows(module.decode(v, module.encode(v, x)), mesh.data)
    return images.astype(np.float32) / 127.5 - 1, y.cpu().numpy(), layout


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", default="127.0.0.1:29500", help="host:port of rank 0, or an init-method URL")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default nccl on cards, gloo on the CPU; gloo for ranks sharing one card")
    p.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("DATA", "MODEL"),
                   help="mesh shape of the steps (default: every rank on 'data')")
    p.add_argument("--config", nargs="+", default=["IAN_simple"], help="model config names or paths")
    p.add_argument("--batch-size", type=int, nargs="+", default=[16], help="global batch, one per config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=0, help="time this many more G + D pairs per config")
    p.add_argument("--infer-mesh", type=int, nargs=2, default=None, metavar=("DATA", "MODEL"),
                   help="then encode + decode the first config with the weights sharded on this mesh")
    p.add_argument("--out", default=None,
                   help="a directory: rank 0 writes the whole Adam first moments after each config's checked "
                        "G + D pair (mu_<config>.pt) and the encode + decode's input and output (infer.npz)")
    p.add_argument("--timeout", type=float, default=SETUP_TIMEOUT_S, help="seconds any peer may be waited for")
    p.add_argument("--no-tf32", action="store_true",
                   help="float32 convolutions and products without TF32 (PyTorch lets cuDNN use it by default), "
                        "to compare with a float32 reference")
    a = p.parse_args(argv)
    if a.no_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch_sizes = a.batch_size * len(a.config) if len(a.batch_size) == 1 else a.batch_size
    if len(batch_sizes) != len(a.config):
        p.error("--batch-size takes one value, or one per --config")
    mesh = init_multihost(a.coordinator, a.num_processes, a.process_id, a.device,
                          tuple(a.mesh) if a.mesh else None, a.backend, a.timeout)
    rank = dist.get_rank()
    for config, bs in zip(a.config, batch_sizes):
        out = run_demo(mesh, bs, config, a.seed, a.repeats)
        print("MULTIHOST_LAUNCHES " + json.dumps({"rank": rank, "config": config, "launches": out["launches"],
                                                  "state_sha256": out["state_sha256"]}), flush=True)
        if a.out and rank == 0:
            os.makedirs(a.out, exist_ok=True)
            torch.save(out["mu"], os.path.join(a.out, f"mu_{os.path.basename(config)}.pt"))
        if rank == 0:
            print("MULTIHOST_METRICS " + json.dumps({"config": config, "batch_size": bs, "mesh": list(mesh.shape),
                                                     "backend": dist.get_backend(), "gen": out["gen"],
                                                     "discrim": out["discrim"],
                                                     "ms_per_g_and_d_step": out["ms_per_g_and_d_step"]}),
                  flush=True)
    if a.infer_mesh:
        infer_mesh = make_mesh(tuple(a.infer_mesh), devices=[mesh.device] * a.num_processes)
        x, y, layout = demo_infer(infer_mesh, INFER_BATCH, a.config[0], a.seed)
        if rank == 0:
            print("MULTIHOST_INFER " + json.dumps({"config": a.config[0], "batch_size": INFER_BATCH,
                                                   "mesh": list(infer_mesh.shape), "sharded": sorted(layout)}),
                  flush=True)
            if a.out:
                np.savez(os.path.join(a.out, "infer.npz"), x=x, y=y)
    dist.barrier()  # every rank finished its work
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
