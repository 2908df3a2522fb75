"""The IAN training recipe in plain PyTorch (`train_IAN.py:47-352` of the
published code): three forward passes a step, the losses, the parameter
partitions and three Adam states, the generator and discriminator steps
alternating. A step is a function of (variables, Adam state, batch, z_rand,
noise, lr) and returns new ones; nothing is updated in place.

Partitions (`train_IAN.py:184-194`, 253-276): the discriminator is the
encoder's conv tower with its BNs, the minibatch layer and the output dense;
the latent heads (enc_fc1, enc_mu, enc_logsigma and their BNs) train on
every step; the generator is the decoder; the MADE nets of the IAF are in no
update and keep their initial values; BN running statistics and masks are
state, updated from the real batch's pass and the reconstruction's decode.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.models import Model, is_trainable

ADAM_B2, ADAM_EPS = 0.999, 1e-8
LATENT = ("enc_fc1.", "bnorm_enc_fc1.", "enc_mu.", "mu_bnorm.", "enc_logsigma.", "ls_bnorm.")
DISCRIM = ("enc_conv", "bnorm2.", "bnorm3.", "bnorm4.", "minibatch_discrim.", "discrimi.")
FROZEN = ("l_IAF_",)
TRAINED = ("gen", "latent", "discrim")
LOSSES = ("discrim_g_loss", "discrim_d_loss", "gen_recon_loss", "gen_sample_loss", "pixel_loss", "feature_loss",
          "kl")


def partition(name):
    if not is_trainable(name):
        return "state"
    if name.startswith(FROZEN):
        return "frozen"
    if name.startswith(LATENT):
        return "latent"
    if name.startswith(DISCRIM):
        return "discrim"
    return "gen"


def init_adam(variables):
    return {p: {"count": 0, "m": {k: torch.zeros_like(t) for k, t in variables.items() if partition(k) == p},
                "v": {k: torch.zeros_like(t) for k, t in variables.items() if partition(k) == p}}
            for p in TRAINED}


def _adam(params, grads, state, lr, b1):
    count = state["count"] + 1
    m = {k: b1 * state["m"][k] + (1 - b1) * grads[k] for k in params}
    v = {k: ADAM_B2 * state["v"][k] + (1 - ADAM_B2) * grads[k] ** 2 for k in params}
    bc1, bc2 = 1 - b1 ** count, 1 - ADAM_B2 ** count
    new = {k: params[k] - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + ADAM_EPS) for k in params}
    return new, {"count": count, "m": m, "v": v}


class Trainer:
    """The configuration's G and D steps in `precision`."""

    def __init__(self, cfg, precision="float32"):
        self.cfg, self.model = cfg, Model(cfg, precision)
        self.tcfg = cfg["train"]
        self.classes = cfg["discriminator"]["classes"]

    def forward(self, v, x, z_rand, noise, upd, x_hat_in=None):
        """The three passes: X, its reconstruction X_hat, samples of z_rand.
        Pass 2 reads `x_hat_in(x_hat)` when given (the cut of a D step)."""
        m = self.model
        mu, ls, g_x = m.encode_stats(v, x, train=True, upd=upd)
        p_x = m.discrim_logits(v, g_x[-1])
        x_hat = m.decode(v, m.iaf(v, mu + torch.exp(ls) * noise), train=True, upd=upd)
        g_xh = m.backbone(v, x_hat if x_hat_in is None else x_hat_in(x_hat), train=True)
        p_x_hat = m.discrim_logits(v, g_xh[-1])
        x_gen = m.decode(v, m.iaf(v, z_rand), train=True)
        p_x_gen = m.discrim_logits(v, m.backbone(v, x_gen, train=True)[-1])
        return {"mu": mu, "ls": ls, "x_hat": x_hat, "g_x": g_x, "g_xh": g_xh,
                "p_x": p_x, "p_x_hat": p_x_hat, "p_x_gen": p_x_gen}

    def losses(self, out, x):
        """The adversarial, pixel, feature and KL terms (`train_IAN.py:169-250`)."""
        def bce(logits, t):
            z = logits[:, 0]
            return (torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-torch.abs(z)))).mean()

        def ce(logits, k):
            return -F.log_softmax(logits, dim=-1)[:, k].mean()

        if self.classes == 3:
            adv = {"discrim_g_loss": ce(out["p_x_hat"], 1) + ce(out["p_x_gen"], 2), "discrim_d_loss": ce(out["p_x"], 0),
                   "gen_recon_loss": ce(out["p_x_hat"], 0), "gen_sample_loss": ce(out["p_x_gen"], 0)}
        else:
            adv = {"discrim_g_loss": bce(out["p_x_hat"], 0.0) + bce(out["p_x_gen"], 0.0),
                   "discrim_d_loss": bce(out["p_x"], 1.0), "gen_recon_loss": bce(out["p_x_hat"], 1.0),
                   "gen_sample_loss": bce(out["p_x_gen"], 1.0)}
        mu, ls = out["mu"], out["ls"]
        return {**adv,
                "pixel_loss": (2.0 * torch.abs(out["x_hat"] - x + 1e-8)).mean(),
                "feature_loss": torch.stack([((a - b) ** 2).mean() for a, b in zip(out["g_x"], out["g_xh"])]).mean(),
                "kl": -0.5 * (1 + 2 * ls - mu ** 2 - torch.exp(2 * ls)).mean()}

    def _ortho(self, v, part):
        """`train_IAN.py:158-165` over the partition's 4-D weights named *W."""
        total = 0.0
        for k, w in v.items():
            if partition(k) == part and k.endswith("W") and w.ndim == 4:
                deconv = k.startswith("dec_conv") and k.endswith(".W")
                y = torch.einsum("iohw,iokw->ohk" if deconv else "oihw,oikw->ohk", w, w)
                total = total + torch.abs(y - torch.eye(w.shape[2], dtype=w.dtype, device=w.device)[None]).sum()
        return total

    def latent_objective(self, v, terms):
        c = self.tcfg
        l2 = sum((t ** 2).sum() for k, t in v.items() if partition(k) == "latent" and (k.endswith("W")))
        return (c["feature_weight"] * terms["feature_loss"] + c["recon_weight"] * terms["pixel_loss"]
                + c["agr_weight"] * terms["gen_recon_loss"] + c["ags_weight"] * terms["gen_sample_loss"]
                + terms["kl"] + c["reg"] * l2)

    def step(self, v, adam, x, z_rand, noise, lr, is_gen):
        """One G (`is_gen`) or D step: (new variables, new Adam state, the
        step's loss terms, the gradients it applied by partition)."""
        c = self.tcfg
        names = [k for k in v if partition(k) in (("gen", "latent") if is_gen else ("discrim", "latent"))]
        leaves = {k: v[k].detach().requires_grad_(True) for k in names}
        w = {**v, **leaves}
        upd = {}
        if is_gen:
            out = self.forward(w, x, z_rand, noise, upd)
            terms = self.losses(out, x)
            total = self.latent_objective(w, terms)
            if c.get("ortho"):
                total = total + c["ortho"] * self._ortho(w, "gen")
            grads = dict(zip(names, torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)))
        else:
            # consider_constant=[X_hat] for the discriminator (`train_IAN.py:253`); the latent heads'
            # objective reaches them through X_hat as well, carried across the cut by the chain rule
            cut = {}

            def x_hat_in(x_hat):
                cut["x_hat"] = x_hat
                cut["leaf"] = x_hat.detach().requires_grad_(True)
                return cut["leaf"]

            out = self.forward(w, x, z_rand, noise, upd, x_hat_in=x_hat_in)
            terms = self.losses(out, x)
            dloss = c["dg_weight"] * terms["discrim_g_loss"] + c["dd_weight"] * terms["discrim_d_loss"]
            if c.get("ortho"):
                dloss = dloss + c["ortho"] * self._ortho(w, "discrim")
            zloss = self.latent_objective(w, terms)
            dnames = [k for k in names if partition(k) == "discrim"]
            znames = [k for k in names if partition(k) == "latent"]
            g_d = torch.autograd.grad(dloss, [leaves[k] for k in dnames], retain_graph=True, allow_unused=True)
            (g_cut,) = torch.autograd.grad(zloss, [cut["leaf"]], retain_graph=True)
            g_z = torch.autograd.grad([zloss, cut["x_hat"]], [leaves[k] for k in znames],
                                      grad_outputs=[torch.ones_like(zloss), g_cut], allow_unused=True)
            grads = {**dict(zip(dnames, g_d)), **dict(zip(znames, g_z))}
        grads = {k: torch.zeros_like(v[k]) if g is None else g.detach() for k, g in grads.items()}
        new_v, new_adam = dict(v), dict(adam)
        for part in (("gen", "latent") if is_gen else ("discrim", "latent")):
            params = {k: v[k] for k in names if partition(k) == part}
            p, new_adam[part] = _adam(params, {k: grads[k] for k in params}, adam[part], lr, c["beta1"])
            new_v.update(p)
        new_v.update(upd)
        return new_v, new_adam, {k: t.detach() for k, t in terms.items()}, grads
