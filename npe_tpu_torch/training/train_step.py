"""Training steps: the counterpart of npe_tpu's jitted `gen_step` /
`discrim_step` (`training/train_step.py`, reference `update_gen` /
`update_discrim`, `train_IAN.py:283-325`), run eagerly.

Optimizer: three Adam states, one per trainable partition, as the
reference's three `lasagne.updates.adam` dicts, with the latent-head
('Z_gen') state advancing on EVERY step because that update dict is merged
into both players (`train_IAN.py:274-276`). The learning rate is an argument
of every step: a Python float, or a 0-d tensor on the state's device that
the step reads there (what a captured step takes, so that a new rate needs
no new capture; the two give the same step bit for bit). Adam is written
out as a plain function over the dict (optax's `scale_by_adam`: m_hat /
(sqrt(v_hat) + eps), one shared count per partition state).

A step is a function state -> new state: it allocates the new parameters,
moments and BN statistics and leaves the tensors of the state it was given
untouched (nothing is updated in place). The captured chunk
(`make_chunk_rows`, `training/captured.py`) copies each new state into its
static buffers, so there a state is consumed by the next chunk.

The train state is a nested dict:
    {"parts": {gen, latent, discrim, frozen, state: {name: tensor}},
     "opt": {gen, latent, discrim: {"count": int32 0-d tensor,
                                    "mu": {name: tensor}, "nu": {...}}},
     "step": int32 0-d tensor}

A step takes (state, x, z_rand, noise, lr): the sample latents and the
reparameterization noise come from the caller (the chunk loop draws both
from its torch.Generator). No step synchronises with the host, branches on a
device value or makes a shape that depends on data, so that a step can be
captured as a CUDA graph (`training/captured.py`): metrics come back as 0-d
tensors on the device.

On a mesh (`parallel.mesh`, npe_tpu's sharded step): x, z_rand and noise
are this rank's rows of the global batch; the step sets the mesh's data
axis (`parallel.collectives.data_axis`) around its forward and backward, so
that batch norm, minibatch discrimination, the losses and the metrics are
the global batch's, sums the gradients over the axis and updates the same
parameters, moments and BN statistics on every rank: one process's step on
the global batch. Weights the state holds in 'model' slices (its `layout`,
`parallel.mesh.state_layout`) are gathered before use, and the state keeps
its slices. Every rank runs the same
backward passes in the same order: each crosses the collectives.
"""

import torch

from npe_tpu_torch.parallel.collectives import data_axis, sum_grads
from npe_tpu_torch.parallel.mesh import batch_rows, unshard_variables
from npe_tpu_torch.training import losses as L
from npe_tpu_torch.training.graph import (
    compute_dtype, compute_metrics, discrim_and_latent_losses, gen_loss_fn,
)
from npe_tpu_torch.utils.profiling import annotate

ADAM_B2 = 0.999
ADAM_EPS = 1e-8
TRAINED = ("gen", "latent", "discrim")


def _moments_dtype(cfg):
    name = cfg.get("moments_dtype")
    if not name:
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"cfg['moments_dtype'] {name!r} is not a floating torch dtype")
    return dt


def init_opt_state(params, moments_dtype=None):
    zeros = lambda p: torch.zeros_like(p, dtype=moments_dtype or p.dtype)  # noqa: E731
    count = torch.zeros((), dtype=torch.int32, device=_device_of(params))
    return {"count": count, "mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()}}


def _device_of(tensors):
    return next((t.device for t in tensors.values()), torch.device("cpu"))


def init_train_state(module, variables, cfg):
    """`variables` (name -> tensor, all on one device) partitioned, with
    zeroed Adam states on the same device. The caller picks the device when
    it calls `module.init(gen, device)`, whose default is the card.
    Masters, moments (unless cfg['moments_dtype']), counts and BN statistics
    are float32 whatever cfg['compute_dtype'] says."""
    compute_dtype(cfg)  # an unknown compute dtype raises here, before any step
    parts = L.partition_variables(variables)
    md = _moments_dtype(cfg)
    return {
        "parts": parts,
        "opt": {p: init_opt_state(parts[p], md) for p in TRAINED},
        "step": torch.zeros((), dtype=torch.int32, device=_device_of(variables)),
    }


def adam_update(params, grads, opt_state, lr, b1, b2=ADAM_B2, eps=ADAM_EPS, moments_dtype=None):
    """One Adam step over a dict: returns (new_params, new_opt_state), both
    freshly allocated. With `moments_dtype` (cfg['moments_dtype'], e.g.
    'bfloat16') m and v are STORED in that type and the arithmetic runs in
    the parameters' type (float32) every step, so the only deviation from
    float32 moments is the rounding of m and v between steps. `lr`: a Python
    float, or a 0-d tensor on the parameters' device, read there in their
    type (the same product as the float's)."""
    names = list(params)
    if not names:
        return {}, {"count": opt_state["count"] + 1, "mu": {}, "nu": {}}
    p = [params[k] for k in names]
    dt = p[0].dtype  # float32; the moments are widened to it, whatever they are stored in
    if isinstance(lr, torch.Tensor):
        lr = lr.to(dt)
    g = [grads[k].to(dt) for k in names]
    m = [opt_state["mu"][k].to(dt) for k in names]
    v = [opt_state["nu"][k].to(dt) for k in names]
    count = opt_state["count"] + 1
    mu = torch._foreach_mul(m, b1)
    torch._foreach_add_(mu, g, alpha=1 - b1)
    nu = torch._foreach_mul(v, b2)
    torch._foreach_addcmul_(nu, g, g, value=1 - b2)
    bc1 = 1 - torch.pow(b1, count.to(dt))
    bc2 = 1 - torch.pow(b2, count.to(dt))
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, lr)
    new_p = torch._foreach_sub(p, update)
    if moments_dtype is not None:
        mu = [t.to(moments_dtype) for t in mu]
        nu = [t.to(moments_dtype) for t in nu]
    return dict(zip(names, new_p)), {"count": count, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))}


def _grads_finite(*grad_dicts):
    """A 0-d bool tensor on the device: every gradient finite. (The 2-norm
    of a tensor that holds an inf or a NaN is not finite.)"""
    grads = [g for d in grad_dicts for g in d.values()]
    return torch.isfinite(torch.stack(torch._foreach_norm(grads))).all()


def _guarded(ok, new, old):
    """Select new vs old by the 0-d flag `ok`, over nested dicts and tuples
    of tensors."""
    if isinstance(new, dict):
        return {k: _guarded(ok, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_guarded(ok, n, o) for n, o in zip(new, old))
    return torch.where(ok, new, old)


def _leaves(params):
    """The same storage as leaves of a fresh autograd graph."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _grad(outputs, leaves, grad_outputs=None, retain_graph=False):
    grads = torch.autograd.grad(outputs, list(leaves.values()), grad_outputs=grad_outputs,
                                retain_graph=retain_graph, allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), grads)}


def _other(parts, names, mesh, layout):
    with torch.no_grad():
        return unshard_variables({k: v for p in names for k, v in parts[p].items()}, mesh, layout)


def gen_grads(module, cfg, parts, x, z_rand, noise, mesh=None, layout=None):
    """The G step's gradients: (g_gen, g_latent, out, upd), in the shapes
    of `parts` (the 'model' slices `layout` names, if any); this rank's
    share of them under a data axis."""
    gl = _leaves({**parts["gen"], **parts["latent"]})
    other = _other(parts, ("discrim", "frozen", "state"), mesh, layout)
    loss, (out, upd) = gen_loss_fn(unshard_variables(gl, mesh, layout), other, module, cfg, x, z_rand, noise)
    grads = _grad(loss, gl)
    return ({k: g for k, g in grads.items() if k in parts["gen"]},
            {k: g for k, g in grads.items() if k in parts["latent"]}, out, upd)


def discrim_grads(module, cfg, parts, x, z_rand, noise, mesh=None, layout=None):
    """The D step's gradients from one forward: (g_discrim, g_latent, out,
    upd); `graph.discrim_and_latent_losses` says why they are the gradients
    of `discrim_loss_fn` and of `latent_loss_fn`. Three backward passes over
    one graph, in a fixed order (under a data axis each crosses the
    collectives of batch norm and minibatch discrimination)."""
    d, lat = _leaves(parts["discrim"]), _leaves(parts["latent"])
    other = _other(parts, ("gen", "frozen", "state"), mesh, layout)
    dloss, zloss, (out, upd) = discrim_and_latent_losses(unshard_variables(d, mesh, layout),
                                                         unshard_variables(lat, mesh, layout), other, module, cfg, x, z_rand, noise)
    g_d = _grad(dloss, d, retain_graph=True)
    x_hat_in, x_hat = out["cut"]  # in the compute dtype, and so is g_cut
    (g_cut,) = torch.autograd.grad(zloss, [x_hat_in], retain_graph=True)
    g_z = _grad([zloss, x_hat], lat, grad_outputs=[torch.ones_like(zloss), g_cut])
    return g_d, g_z, out, upd


def make_train_steps(module, cfg, mesh=None, layout=None):
    """Returns (gen_step, discrim_step):
    state, x, z_rand, noise, lr -> (state, metrics).

    `mesh` (`parallel.mesh.Mesh`): the state as `shard_train_state(state,
    mesh, layout)` holds it and this rank's rows of the global batch; the
    metrics are the global batch's, the same on every rank.

    cfg['skip_nonfinite_updates'] (default off, the faithful recipes'
    semantics): if any gradient of the step is inf/NaN, the whole update
    (params, Adam moments and counts, BN running stats) is dropped by a
    `torch.where` on a device flag, and the step reports update_skipped = 1
    as a device scalar.

    cfg['compute_dtype'] ('bfloat16'): the forward and backward run in bf16
    (`graph.to_compute`), the gradients reach the float32 masters in
    float32, and Adam, the guard and the BN statistics run on float32."""
    compute_dtype(cfg)
    b1 = cfg["beta1"]
    md = _moments_dtype(cfg)
    n_classes = module.N_DISCRIM_CLASSES
    guard = bool(cfg.get("skip_nonfinite_updates"))

    def step(state, x, z_rand, noise, lr, player, grads_fn):
        parts, opt = state["parts"], state["opt"]
        with data_axis(mesh.data if mesh is not None else None):
            g_player, g_lat, out, upd = grads_fn(module, cfg, parts, x, z_rand, noise, mesh=mesh, layout=layout)
            metrics = compute_metrics(cfg, out, x, n_classes)
        if mesh is not None:
            g_player, g_lat = sum_grads([g_player, g_lat], mesh.data)
        new = {player: adam_update(parts[player], g_player, opt[player], lr, b1, moments_dtype=md),
               "latent": adam_update(parts["latent"], g_lat, opt["latent"], lr, b1, moments_dtype=md)}
        # BN running stats from the real-X pass and the reconstruction decode
        new_state_vars = {**parts["state"], **upd}
        if guard:
            ok = _grads_finite(g_player, g_lat)
            new = {p: _guarded(ok, new[p], (parts[p], opt[p])) for p in new}
            new_state_vars = _guarded(ok, new_state_vars, parts["state"])
            metrics["update_skipped"] = 1.0 - ok.to(torch.float32)
        return {
            "parts": {**parts, **{p: new[p][0] for p in new}, "state": new_state_vars},
            "opt": {**opt, **{p: new[p][1] for p in new}},
            "step": state["step"] + 1,
        }, metrics

    def gen_step(state, x, z_rand, noise, lr):
        return step(state, x, z_rand, noise, lr, "gen", gen_grads)

    def discrim_step(state, x, z_rand, noise, lr):
        return step(state, x, z_rand, noise, lr, "discrim", discrim_grads)

    return gen_step, discrim_step


# AdaptiveRatioGuard constants (train.AdaptiveRatioGuard is the host-side
# statement of the same semantics; tests assert the two agree step-for-step).
GUARD_DECAY = 0.9
GUARD_CHANCE = 0.5


def guard_schedule(scheduled_gen, ema, threshold):
    """Restatement of `train.AdaptiveRatioGuard.should_gen` on tensors: a
    step scheduled for D by the faithful alternation trains G instead when
    the accuracy EMA exceeds `threshold`. Returns (is_gen, skip_d), bool
    tensors on ema's device."""
    scheduled_gen = torch.as_tensor(scheduled_gen, dtype=torch.bool, device=ema.device)
    skip_d = torch.logical_and(~scheduled_gen, ema > threshold)
    return torch.logical_or(scheduled_gen, skip_d), skip_d


def guard_ema_update(ema, is_gen, skip_d, d_acc):
    """The guard's EMA dynamics on tensors: a D step that ran observes its
    accuracy; a skipped D slot decays toward chance (which bounds the skip
    streak, see AdaptiveRatioGuard); a scheduled G step leaves the EMA
    untouched."""
    is_gen = torch.as_tensor(is_gen, dtype=torch.bool, device=ema.device)
    skip_d = torch.as_tensor(skip_d, dtype=torch.bool, device=ema.device)
    observed = torch.where(skip_d, torch.full_like(ema, GUARD_CHANCE), d_acc.to(ema.dtype))
    return torch.where(
        torch.logical_and(is_gen, ~skip_d), ema, GUARD_DECAY * ema + (1 - GUARD_DECAY) * observed
    )


class EagerSteps:
    """The chunk loop's steps run eagerly, each a new state: the path under a
    mesh, and the reference the captured steps (`captured.StepRunner`, the
    same interface) are held against. `step` draws z_rand, then the noise,
    for the whole global batch from `gen` and keeps this rank's rows
    [lo, hi), so that every rank's generator stays the single-process
    stream; it returns the step's metrics as a float32 row in the order of
    `keys`."""

    def __init__(self, module, cfg, mesh=None, layout=None):
        self.steps = make_train_steps(module, cfg, mesh=mesh, layout=layout)
        self.shape = (cfg["batch_size"], cfg["num_latents"])
        self.rows = batch_rows(cfg["batch_size"], mesh)
        self.state = self.lr = self.keys = None

    def begin(self, state, lr):
        self.state, self.lr = state, lr

    def step(self, is_gen, xb, gen):
        with annotate("npe.step.G" if is_gen else "npe.step.D"):
            lo, hi = self.rows
            z_rand, noise = (torch.randn(self.shape, generator=gen, device=xb.device, dtype=xb.dtype)[lo:hi]
                             for _ in range(2))
            self.state, m = self.steps[0 if is_gen else 1](self.state, xb, z_rand, noise, self.lr)
            self.keys = list(m)
            return torch.stack([m[k].to(torch.float32) for k in self.keys])


def make_chunk_rows(module, cfg, num_batches, guard_acc=None, mesh=None, layout=None, eager=False):
    """The chunk "program" step by step: a Python loop over `num_batches`
    steps, alternating G/D by `(itr0 + i) % (update_ratio + 1)` like the
    reference's host loop (`train_IAN.py:493-509`), with z_rand and the noise
    drawn from `gen` (a torch.Generator on the chunk's device), z_rand first,
    then the noise, per batch.

    Signature: chunk_rows(state, x_chunk, itr0, gen, lr[, ema]) ->
        (state, keys, table, is_gen_flags, ema)
    x_chunk is (num_batches * batch_size, 3, 64, 64) staged data; table is
    the (num_batches, len(keys)) float32 device tensor of each step's
    metrics, is_gen_flags a list of bools, ema None without the guard.

    With `mesh=None` the steps are npe_tpu's one program: a
    `captured.StepRunner` for the chunk's device and dtype, made at the
    first chunk and kept, replays one CUDA graph per step kind on the card,
    and on the CPU runs the same static buffers with each step called
    directly. The state it returns is the runner's buffers, which the next
    chunk updates in place: a state passed in is consumed, as npe_tpu's
    donated one (`captured.py` has the rules). A capture or replay that
    fails raises. `eager=True` runs `EagerSteps` instead: each step a new
    state, nothing in place (the reference the tests and chip_smoke.py hold
    the captured chunk against).

    Under a `mesh` (`--data-parallel`; `layout` as `make_train_steps`) the
    steps stay eager (`EagerSteps`): no collective of the process group is
    captured. x_chunk holds this rank's rows of each global batch, in batch
    order (batch i's rows at [i * b, (i + 1) * b) for the local batch b =
    batch_size / D).

    Without the guard nothing here synchronises with the host: the schedule
    is host arithmetic. guard_acc (cfg['adaptive_ratio_acc'], the documented
    D-saturation deviation): a scheduled D step whose accuracy EMA exceeds
    the threshold trains G instead, and the EMA decays toward chance while
    skipping (`train.AdaptiveRatioGuard`'s semantics). The loop cannot
    branch on a device value without reading it, so with the guard it reads
    the decision back to the host on each scheduled D step and runs (or
    replays) the step it chose: one synchronisation per such step. The EMA
    itself stays a 0-d device tensor threaded through the signature."""
    from npe_tpu_torch.training.captured import StepRunner

    period = cfg["update_ratio"] + 1
    lo, hi = batch_rows(cfg["batch_size"], mesh)
    local = hi - lo
    runners = {}
    eager_steps = EagerSteps(module, cfg, mesh=mesh, layout=layout) if eager or mesh is not None else None

    def steps_for(state, x_chunk):
        if eager_steps is not None:
            return eager_steps
        key = (x_chunk.device, x_chunk.dtype)
        if key not in runners:
            runners[key] = StepRunner(module, cfg, state, x_chunk)
        return runners[key]

    def chunk_rows(state, x_chunk, itr0, gen, lr, ema=None):
        if (ema is None) != (guard_acc is None):
            raise ValueError("the accuracy EMA is passed exactly when guard_acc is set")
        steps = steps_for(state, x_chunk)
        steps.begin(state, lr)
        rows, is_gen_flags = [], []
        for i in range(num_batches):
            scheduled_gen = (itr0 + i) % period == 0
            is_gen, skip_d = scheduled_gen, False
            if guard_acc is not None and not scheduled_gen:
                is_gen = skip_d = bool(guard_schedule(False, ema, guard_acc)[0])  # the one host read
            row = steps.step(is_gen, x_chunk[i * local : (i + 1) * local], gen)
            if guard_acc is not None:
                ema = guard_ema_update(ema, is_gen, skip_d, row[steps.keys.index("discrim_acc")])
            rows.append(row)
            is_gen_flags.append(is_gen)
        return steps.state, steps.keys, torch.stack(rows), is_gen_flags, ema

    chunk_rows.runners = runners
    return chunk_rows


def make_chunk_step(module, cfg, num_batches, guard_acc=None, mesh=None, layout=None, eager=False):
    """`make_chunk_rows`'s chunk with its metrics averaged per player on the
    device.

    Signature: chunk_step(state, x_chunk, itr0, gen, lr[, ema]) ->
        (state, gen_metrics, discrim_metrics, gen_count[, ema])
    The metric dicts hold 0-d device tensors, already averaged over this
    chunk's G / D steps; gen_count is a Python int. The returned state is
    consumed by the next chunk of the same chunk_step unless it is eager
    (`make_chunk_rows`)."""
    chunk_rows = make_chunk_rows(module, cfg, num_batches, guard_acc=guard_acc, mesh=mesh, layout=layout,
                                 eager=eager)

    def chunk_step(state, x_chunk, itr0, gen, lr, ema=None):
        state, keys, table, is_gen_flags, ema = chunk_rows(state, x_chunk, itr0, gen, lr, ema)
        with annotate("npe.wait"):  # a copy from pageable memory waits for the card
            gen_w = torch.tensor(is_gen_flags, dtype=torch.float32, device=x_chunk.device)
        n_gen = sum(is_gen_flags)
        weights = torch.stack([gen_w / max(n_gen, 1), (1 - gen_w) / max(num_batches - n_gen, 1)])
        means = (weights[:, :, None] * table[None]).sum(dim=1)  # (2, keys)
        gen_m = {k: means[0, j] for j, k in enumerate(keys)}
        dis_m = {k: means[1, j] for j, k in enumerate(keys)}
        if guard_acc is None:
            return state, gen_m, dis_m, n_gen
        return state, gen_m, dis_m, n_gen, ema

    return chunk_step


def copy_state(state):
    """A copy of a train state (every tensor cloned on its device): what a
    caller keeps of a state that the next captured chunk will update in
    place."""
    return {k: copy_state(v) if isinstance(v, dict) else v.clone() for k, v in state.items()}


def variables_of(state):
    return L.merge_partitions(state["parts"])
