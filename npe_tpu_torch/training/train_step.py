"""Training steps: the counterpart of npe_tpu's jitted `gen_step` /
`discrim_step` (`training/train_step.py`, reference `update_gen` /
`update_discrim`, `train_IAN.py:283-325`), run eagerly.

Optimizer: three Adam states, one per trainable partition, as the
reference's three `lasagne.updates.adam` dicts, with the latent-head
('Z_gen') state advancing on EVERY step because that update dict is merged
into both players (`train_IAN.py:274-276`). The learning rate is an argument
of every step. Adam is written out as a plain function over the dict
(optax's `scale_by_adam`: m_hat / (sqrt(v_hat) + eps), one shared count per
partition state).

A step is a function state -> new state: it allocates the new parameters,
moments and BN statistics and leaves the tensors of the state it was given
untouched (nothing is updated in place), so a caller may keep a reference to
an older state, as the async checkpointer does, while training goes on.

The train state is a nested dict:
    {"parts": {gen, latent, discrim, frozen, state: {name: tensor}},
     "opt": {gen, latent, discrim: {"count": int32 0-d tensor,
                                    "mu": {name: tensor}, "nu": {...}}},
     "step": int32 0-d tensor}

A step takes (state, x, z_rand, noise, lr): the sample latents and the
reparameterization noise come from the caller (the chunk loop draws both
from its torch.Generator). No step synchronises with the host: metrics come
back as 0-d tensors on the device.
"""

import torch

from npe_tpu_torch.training import losses as L
from npe_tpu_torch.training.graph import (
    compute_dtype, compute_metrics, discrim_and_latent_losses, gen_loss_fn,
)

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
    float32 moments is the rounding of m and v between steps."""
    names = list(params)
    if not names:
        return {}, {"count": opt_state["count"] + 1, "mu": {}, "nu": {}}
    p = [params[k] for k in names]
    dt = p[0].dtype  # float32; the moments are widened to it, whatever they are stored in
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


def gen_grads(module, cfg, parts, x, z_rand, noise):
    """The G step's gradients: (g_gen, g_latent, out, upd)."""
    gl = _leaves({**parts["gen"], **parts["latent"]})
    other = {**parts["discrim"], **parts["frozen"], **parts["state"]}
    loss, (out, upd) = gen_loss_fn(gl, other, module, cfg, x, z_rand, noise)
    grads = _grad(loss, gl)
    return ({k: g for k, g in grads.items() if k in parts["gen"]},
            {k: g for k, g in grads.items() if k in parts["latent"]}, out, upd)


def discrim_grads(module, cfg, parts, x, z_rand, noise):
    """The D step's gradients from one forward: (g_discrim, g_latent, out,
    upd); `graph.discrim_and_latent_losses` says why they are the gradients
    of `discrim_loss_fn` and of `latent_loss_fn`."""
    d, lat = _leaves(parts["discrim"]), _leaves(parts["latent"])
    other = {**parts["gen"], **parts["frozen"], **parts["state"]}
    dloss, zloss, (out, upd) = discrim_and_latent_losses(d, lat, other, module, cfg, x, z_rand, noise)
    g_d = _grad(dloss, d, retain_graph=True)
    x_hat_in, x_hat = out["cut"]  # in the compute dtype, and so is g_cut
    (g_cut,) = torch.autograd.grad(zloss, [x_hat_in], retain_graph=True)
    g_z = _grad([zloss, x_hat], lat, grad_outputs=[torch.ones_like(zloss), g_cut])
    return g_d, g_z, out, upd


def make_train_steps(module, cfg):
    """Returns (gen_step, discrim_step):
    state, x, z_rand, noise, lr -> (state, metrics).

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
        g_player, g_lat, out, upd = grads_fn(module, cfg, parts, x, z_rand, noise)
        new = {player: adam_update(parts[player], g_player, opt[player], lr, b1, moments_dtype=md),
               "latent": adam_update(parts["latent"], g_lat, opt["latent"], lr, b1, moments_dtype=md)}
        # BN running stats from the real-X pass and the reconstruction decode
        new_state_vars = {**parts["state"], **upd}
        metrics = compute_metrics(cfg, out, x, n_classes)
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


def make_chunk_step(module, cfg, num_batches, guard_acc=None):
    """The chunk "program": a Python loop over `num_batches` eager steps,
    alternating G/D by `(itr0 + i) % (update_ratio + 1)` like the reference's
    host loop (`train_IAN.py:493-509`), with z_rand and the noise drawn from
    `gen` (a torch.Generator on the chunk's device) and metrics averaged on
    the device.

    Signature: chunk_step(state, x_chunk, itr0, gen, lr[, ema]) ->
        (state, gen_metrics, discrim_metrics, gen_count[, ema])
    x_chunk is (num_batches * batch_size, 3, 64, 64) staged data; the metric
    dicts hold 0-d device tensors, already averaged over this chunk's G / D
    steps; gen_count is a Python int. Per batch the generator gives z_rand
    first, then the noise.

    Without the guard nothing here synchronises with the host: the schedule
    is host arithmetic, and the per-step metrics are stacked and averaged on
    the device. guard_acc (cfg['adaptive_ratio_acc'], the documented
    D-saturation deviation): a scheduled D step whose accuracy EMA exceeds
    the threshold trains G instead, and the EMA decays toward chance while
    skipping (`train.AdaptiveRatioGuard`'s semantics). Eager code cannot
    branch on a device value without reading it, so with the guard the loop
    reads the decision back to the host on each scheduled D step: one
    synchronisation per such step. The EMA itself stays a 0-d device tensor
    threaded through the signature."""
    gen_step, discrim_step = make_train_steps(module, cfg)
    period = cfg["update_ratio"] + 1
    bs = cfg["batch_size"]
    zdim = cfg["num_latents"]

    def chunk_step(state, x_chunk, itr0, gen, lr, ema=None):
        if (ema is None) != (guard_acc is None):
            raise ValueError("the accuracy EMA is passed exactly when guard_acc is set")
        device = x_chunk.device
        rows, is_gen_flags = [], []
        for i in range(num_batches):
            xb = x_chunk[i * bs : (i + 1) * bs]
            z_rand = torch.randn((bs, zdim), generator=gen, device=device)
            noise = torch.randn((bs, zdim), generator=gen, device=device)
            scheduled_gen = (itr0 + i) % period == 0
            is_gen, skip_d = scheduled_gen, False
            if guard_acc is not None and not scheduled_gen:
                is_gen = skip_d = bool(guard_schedule(False, ema, guard_acc)[0])  # the one host read
            state, m = (gen_step if is_gen else discrim_step)(state, xb, z_rand, noise, lr)
            if guard_acc is not None:
                ema = guard_ema_update(ema, is_gen, skip_d, m["discrim_acc"])
            rows.append(m)
            is_gen_flags.append(is_gen)
        keys = list(rows[0])
        table = torch.stack([torch.stack([m[k].to(torch.float32) for k in keys]) for m in rows])  # (batches, keys)
        gen_w = torch.tensor(is_gen_flags, dtype=torch.float32, device=device)
        n_gen = sum(is_gen_flags)
        weights = torch.stack([gen_w / max(n_gen, 1), (1 - gen_w) / max(num_batches - n_gen, 1)])
        means = (weights[:, :, None] * table[None]).sum(dim=1)  # (2, keys)
        gen_m = {k: means[0, j] for j, k in enumerate(keys)}
        dis_m = {k: means[1, j] for j, k in enumerate(keys)}
        if guard_acc is None:
            return state, gen_m, dis_m, n_gen
        return state, gen_m, dis_m, n_gen, ema

    return chunk_step


def variables_of(state):
    return L.merge_partitions(state["parts"])
