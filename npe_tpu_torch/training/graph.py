"""The IAN training graph: forward passes and the per-partition objectives
(npe_tpu `training/graph.py`, reference `make_training_functions`,
`train_IAN.py:47-352`), as functions of (partitioned params, the other
variables, batch, z_rand, noise).

Three forward passes per step, like the reference (`train_IAN.py:116-149`):
  pass 1: X      -> recon X_hat, latent stats, D(X), introspect g(X)
  pass 2: X_hat  -> D(X_hat), introspect g(X_hat)
  pass 3: decode(Z_rand) -> D(X_gen)

BN runs in batch-stats mode on all passes; running-stat updates are taken
from the real-X pass and the reconstruction decode, and leave here detached
from the autograd graph. The reparameterization noise is an argument (`noise`:
the eps tensor, or a torch.Generator to draw it from), never global state.

Mixed precision (cfg['compute_dtype'], npe_tpu `graph.py:to_compute`): the
loss functions cast the trainable variables and the batch to the compute
dtype after the leaves that autograd differentiates, so the gradients come
back through the casts in float32, to float32 masters; the BN running
statistics and the masks stay float32, and the forward's outputs and BN
updates are widened to float32 before any loss. No autocast: every op
rounds where npe_tpu's explicit cast rounds.

Under a training step's data axis (`parallel.collectives.data_axis`) each
objective is this rank's share of the global batch's, and its penalties of
the weights alone count on the axis' first rank only (`once`), so the
objectives summed over the axis are one process's; the metrics come back
summed over it.
"""

import torch

from npe_tpu_torch.models.common import is_trainable
from npe_tpu_torch.parallel.collectives import once, sum_metrics
from npe_tpu_torch.training import losses as L
from npe_tpu_torch.utils.cast import resolve_dtype


def compute_dtype(cfg):
    """The dtype the step computes in: cfg['compute_dtype'] through
    `utils.cast.resolve_dtype` (None / "float32" or "bfloat16"; anything else
    raises ValueError)."""
    try:
        return resolve_dtype(cfg.get("compute_dtype"))
    except ValueError:
        raise ValueError(f"cfg['compute_dtype'] {cfg['compute_dtype']!r}: the port trains in "
                         "float32 or bfloat16 only") from None


def to_compute(variables, x, z_rand, cfg):
    """(variables, x, z_rand) in the compute dtype: every trainable floating
    variable and the batch cast, the rest (BN running statistics, masks) as
    it is. In float32 (no compute_dtype) the same tensors come back."""
    dt = compute_dtype(cfg)
    if dt == torch.float32:
        return variables, x, z_rand
    cast = {k: v.to(dt) for k, v in variables.items() if is_trainable(k) and v.is_floating_point()}
    return {**variables, **cast}, x.to(dt), z_rand.to(dt)


def _f32_tree(tree):
    """Every floating tensor of a dict / tuple / list tree widened to float32
    (float64 stays float64, for the float64 parity runs)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_f32_tree(v) for v in tree)
    return tree.float() if tree.dtype in (torch.bfloat16, torch.float16) else tree


def forward_all(module, variables, x, z_rand, noise, upd=None, cut_x_hat=False):
    """Full three-pass training forward. x: (B, 3, 64, 64) in [-1, 1].

    `cut_x_hat`: pass 2 reads a detached copy of x_hat that is a leaf of its
    own, returned with x_hat as out['cut'] = (x_hat_in, x_hat), both in the
    forward's dtype, so that a caller can take pass 2's gradient up to the
    reconstruction and carry it on (or not) by hand."""
    mu, ls, g_x = module.encode_stats(variables, x, train=True, upd=upd)
    p_x = module.discrim_logits(variables, g_x[-1])
    z0 = module.sample_latent(mu, ls, noise)
    z = module.iaf(variables, z0)[0] if module.HAS_IAF else z0
    # Decoder BN running stats update from this (reconstruction) pass:
    # eval-mode decoding would otherwise normalize with init-time stats.
    x_hat = module.decode(variables, z, train=True, upd=upd)

    # pass 2: discriminator + introspection on the reconstruction
    x_hat_in = x_hat.detach().requires_grad_(True) if cut_x_hat else x_hat
    g_xh = module.backbone(variables, x_hat_in, True, None)
    p_x_hat = module.discrim_logits(variables, g_xh[-1])

    # pass 3: discriminator on fresh samples
    x_gen = module.decode_pre_iaf(variables, z_rand, train=True, upd=None)
    g_gen = module.backbone(variables, x_gen, True, None)
    p_x_gen = module.discrim_logits(variables, g_gen[-1])

    out = {
        "mu": mu,
        "ls": ls,
        "x_hat": x_hat,
        "p_x": p_x,
        "p_x_hat": p_x_hat,
        "p_x_gen": p_x_gen,
        "g_x": g_x,
        "g_xh": g_xh,
    }
    if cut_x_hat:
        out["cut"] = (x_hat_in, x_hat)
    return out


def _forward_f32(module, variables, x, z_rand, noise, cfg, upd=None, cut_x_hat=False):
    """forward_all in the compute dtype, its outputs widened to float32 for
    the losses (npe_tpu `_f32_tree(forward_all(...))`); the cut's pair stays
    in the compute dtype, so that the gradient carried across it keeps its
    dtype."""
    variables, xc, zc = to_compute(variables, x, z_rand, cfg)
    raw = forward_all(module, variables, xc, zc, noise, upd=upd, cut_x_hat=cut_x_hat)
    cut = raw.pop("cut", None)
    out = _f32_tree(raw)
    if cut is not None:
        out["cut"] = cut
    return out


def compute_metrics(cfg, out, x, n_classes):
    """The step's metrics as 0-d tensors on the device, outside autograd;
    under a data axis the global batch's, the same on every rank (each is a
    sum of the ranks' shares, and pixel_acc is formed after the sum)."""
    with torch.no_grad():
        adv = L.adversarial_losses(out["p_x"], out["p_x_hat"], out["p_x_gen"], n_classes)
        m = sum_metrics({
            **adv,
            "pixel_loss": L.pixel_l1(out["x_hat"], x),
            "feature_loss": L.feature_matching(out["g_x"], out["g_xh"]),
            "kl": L.kl_to_standard_normal(out["mu"], out["ls"]),
            "pixel_acc": L.pixel_mse(out["x_hat"], x),
        })
        m["pixel_acc"] = 1.0 - m["pixel_acc"]
        return m


def _detached(upd):
    return {k: v.detach() for k, v in _f32_tree(upd).items()}


def _only(params, partition):
    return {k: v for k, v in params.items() if L.partition_of(k) == partition}


def _latent_objective(cfg, out, x, adv, latent_params):
    """The Z_gen_updates objective (`train_IAN.py:266-273`)."""
    return (
        cfg["feature_weight"] * L.feature_matching(out["g_x"], out["g_xh"])
        + cfg["recon_weight"] * L.pixel_l1(out["x_hat"], x)
        + cfg["agr_weight"] * adv["gen_recon_loss"]
        + cfg["ags_weight"] * adv["gen_sample_loss"]
        + L.kl_to_standard_normal(out["mu"], out["ls"])
        + once(cfg["reg"] * L.l2_penalty(latent_params))
    )


def _discrim_objective(cfg, adv, discrim_params):
    total = cfg["dg_weight"] * adv["discrim_g_loss"] + cfg["dd_weight"] * adv["discrim_d_loss"]
    if cfg.get("ortho"):
        total = total + once(cfg["ortho"] * L.ortho_penalty(discrim_params))
    return total


def gen_loss_fn(gen_latent_params, other, module, cfg, x, z_rand, noise):
    """Scalar whose gradient w.r.t. (gen U latent) params reproduces the
    reference's gen_updates + Z_gen_updates (`train_IAN.py:256-276`):
      wrt decoder params: adv_gen + recon*pixel + feature*fw + ortho_gen
      wrt latent heads:   adv_gen + recon*pixel + feature*fw + kl + l2_Z
    The extra terms are disjoint across the two partitions (kl/l2 touch only
    latent heads; ortho_gen touches only 4-D decoder weights), so one scalar
    serves both. Returns (total, (out, upd)).

    Under cfg['compute_dtype'] the forward runs in that dtype and the losses
    in float32 on the float32 batch and masters (`_forward_f32`)."""
    variables = {**other, **gen_latent_params}
    upd = {}
    out = _forward_f32(module, variables, x, z_rand, noise, cfg, upd=upd)
    adv = L.adversarial_losses(out["p_x"], out["p_x_hat"], out["p_x_gen"], module.N_DISCRIM_CLASSES)
    total = _latent_objective(cfg, out, x, adv, _only(gen_latent_params, "latent"))
    if cfg.get("ortho"):
        total = total + once(cfg["ortho"] * L.ortho_penalty(_only(gen_latent_params, "gen")))
    return total, (out, _detached(upd))


def discrim_loss_fn(discrim_params, other, module, cfg, x, z_rand, noise):
    """Discriminator objective with consider_constant=[X_hat]
    (`train_IAN.py:253`): gradients do not flow into the generator, nor
    through the reconstruction back into the tower."""
    variables = {**other, **discrim_params}
    upd = {}
    out = _forward_f32(module, variables, x, z_rand, noise, cfg, upd=upd, cut_x_hat=True)
    adv = L.adversarial_losses(out["p_x"], out["p_x_hat"], out["p_x_gen"], module.N_DISCRIM_CLASSES)
    return _discrim_objective(cfg, adv, discrim_params), (out, _detached(upd))


def latent_loss_fn(latent_params, other, module, cfg, x, z_rand, noise):
    """Z_gen_updates objective alone (`train_IAN.py:266-273`), used on
    discriminator steps where the latent heads still train."""
    variables = {**other, **latent_params}
    out = _forward_f32(module, variables, x, z_rand, noise, cfg)
    adv = L.adversarial_losses(out["p_x"], out["p_x_hat"], out["p_x_gen"], module.N_DISCRIM_CLASSES)
    return _latent_objective(cfg, out, x, adv, latent_params), (out, {})


def discrim_and_latent_losses(discrim_params, latent_params, other, module, cfg, x, z_rand, noise):
    """Both objectives of a discriminator step from ONE three-pass forward.

    npe_tpu takes one gradient of dloss + zloss and lets XLA merge the two
    forwards (`discrim_loss_fn` runs pass 2 on stop_gradient(x_hat),
    `latent_loss_fn` on the live x_hat: same values). Autograd merges
    nothing, and reusing a live pass 2 for dloss would leak a gradient into
    the discrim partition through x_hat -> decoder -> z -> latent heads ->
    enc_fc1 <- conv tower. So pass 2 runs once, on a cut copy of x_hat
    (`forward_all(cut_x_hat=True)`):

      * dloss reaches the discrim params through the three tower passes
        and, by the cut, not through x_hat: its gradient w.r.t. the discrim
        partition is `discrim_loss_fn`'s;
      * zloss reaches the latent heads directly (pixel loss on the live
        x_hat, kl, l2) and through pass 2 only up to the cut. The caller
        takes d zloss / d x_hat_in and carries it into x_hat by the chain
        rule: grad([zloss, x_hat], latent, grad_outputs=[1, that]), which is
        `latent_loss_fn`'s gradient w.r.t. the latent partition.

    Returns (dloss, zloss, (out, upd)); out['cut'] is (x_hat_in, x_hat) in
    the compute dtype (a bf16 leaf under bf16), and the gradient carried
    across it stays in that dtype."""
    variables = {**other, **discrim_params, **latent_params}
    upd = {}
    out = _forward_f32(module, variables, x, z_rand, noise, cfg, upd=upd, cut_x_hat=True)
    adv = L.adversarial_losses(out["p_x"], out["p_x_hat"], out["p_x_gen"], module.N_DISCRIM_CLASSES)
    dloss = _discrim_objective(cfg, adv, discrim_params)
    zloss = _latent_objective(cfg, out, x, adv, latent_params)
    return dloss, zloss, (out, _detached(upd))
