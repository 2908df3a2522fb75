"""IANv1's non-finite latent gradients on bench_train.py's inputs: the port
against npe_tpu on the same weights, batch and draws.

bench_torch_train.py trains IANv1 at batch 16 from default init (seed 0) on
x = tanh(0.5 randn(seed 1)), z_rand = randn(seed 2), lr 2e-4, drawing the
reparameterization noise of each step from torch.Generator("cuda") seeded
10. On the card the first D step leaves the latent heads non-finite. This
script tells a fault of the port from the model's own overflow
(docs/NUMERICS.md has full IAN's): it runs the first steps (G, D, G, ...)
through the port's `make_train_steps` and through npe_tpu's on the same
variables, the same batch and the same noise, npe_tpu's `sample_latent` fed
the port's eps through its rng argument, and prints each step's metrics and
each side's non-finite parameters.

    python3 scripts/ianv1_nonfinite.py --dump-noise ianv1_noise.npy   # on the card
    python scripts/ianv1_nonfinite.py --noise ianv1_noise.npy          # on the CPU, with JAX

Without --noise the CPU draws its own noise (another stream than the card's).
Full width at batch 16: a few minutes and a few GB on the CPU, in one process.
"""

import argparse
import os
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH, LR, SEED_NOISE = 16, 2e-4, 10


def bench_inputs(module):
    """bench_torch_train.run's weights, batch and latents, on the CPU."""
    variables = module.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.tanh(torch.randn((BATCH, 3, 64, 64), generator=torch.Generator().manual_seed(1)) * 0.5)
    z = torch.randn((BATCH, module.cfg["num_latents"]), generator=torch.Generator().manual_seed(2))
    return variables, x, z


def dump_noise(path, steps):
    """The noise of bench_torch_train.run's first `steps` steps, drawn on the card as it draws them."""
    zdim = 100
    gen = torch.Generator("cuda").manual_seed(SEED_NOISE)
    noise = torch.empty((BATCH, zdim), device="cuda")
    draws = []
    for _ in range(steps):
        torch.randn(noise.shape, generator=gen, out=noise)
        draws.append(noise.cpu().numpy().copy())
    np.save(path, np.stack(draws))
    print(f"{steps} draws of {tuple(noise.shape)} from torch.Generator('cuda') seeded {SEED_NOISE} into {path}")


def compare(noises, steps):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from npe_tpu.models import get_config as jax_config
    from npe_tpu.training import train_step as JTS
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.training import train_step as TS
    from npe_tpu_torch.utils.checkpoints import to_reference

    module = get_config("IANv1")
    cfg = dict(module.cfg, batch_size=BATCH)
    variables, x, z = bench_inputs(module)
    reference = jax_config("IANv1")
    # npe_tpu's module with its sampler taking eps itself through the rng argument
    fed = types.SimpleNamespace(**{k: getattr(reference, k) for k in dir(reference) if not k.startswith("__")})
    fed.sample_latent = lambda mu, ls, eps: mu + jnp.exp(ls) * eps.astype(mu.dtype)
    jcfg = dict(reference.cfg, batch_size=BATCH)
    jstate = JTS.init_train_state(fed, {k: jnp.asarray(v) for k, v in to_reference(variables).items()}, jcfg)
    jsteps = JTS.make_train_steps(fed, jcfg, donate=False)
    tstate = TS.init_train_state(module, variables, cfg)
    tsteps = TS.make_train_steps(module, cfg)
    x_nhwc, zj = jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(z.numpy())

    def bad(state, finite):
        return sorted(k for part in state["parts"].values() for k, v in part.items() if not finite(v))

    for i in range(steps):
        kind = i % 2  # G, D, G, ...
        tstate, tm = tsteps[kind](tstate, x, z, torch.from_numpy(noises[i]), LR)
        jstate, jm = jsteps[kind](jstate, x_nhwc, zj, jnp.asarray(noises[i]), LR)
        print(f"step {i + 1} {'GD'[kind]}: max |eps| {np.abs(noises[i]).max():.3f}")
        for k in sorted(tm):
            print(f"   {k:18s} port {float(tm[k]): .6e}   npe_tpu {float(jm[k]): .6e}")
        print("   non-finite parameters, port:   ", bad(tstate, lambda v: bool(torch.isfinite(v).all())))
        print("   non-finite parameters, npe_tpu:", bad(jstate, lambda v: bool(jnp.isfinite(v).all())), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dump-noise", default=None, help="on the card: write the draws to this .npy file")
    p.add_argument("--noise", default=None, help="on the CPU: the draws to feed both packages")
    p.add_argument("--steps", type=int, default=3)
    a = p.parse_args(argv)
    if a.dump_noise:
        dump_noise(a.dump_noise, a.steps)
        return 0
    torch.set_num_threads(4)
    if a.noise:
        noises = np.load(a.noise)[:a.steps]
    else:
        gen = torch.Generator().manual_seed(SEED_NOISE)
        noises = np.stack([torch.randn((BATCH, 100), generator=gen).numpy() for _ in range(a.steps)])
    compare(noises, a.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
