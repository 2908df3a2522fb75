"""Traffic kind "train": the trainer's loop over a uint8 set of seeded faces
held on the card, as `training.train.train` runs it when the set fits its
`device_cache_bytes`: per chunk a seeded permutation of the set (a new one
each epoch), one `stage_chunk` gather of the chunk's rows, then one
`StepRunner.step` per batch, G and D in turn (`update_ratio` 1), the
metrics of the chunk's steps read back once at its end. Each step consumes
one batch of the configuration's batch size.

Parameters: faces (the set's size), check_steps (how many of the first
steps the reference follows), trace_seconds.

Set-up builds the one step runner the window uses, and drives it through the
first chunk: its first steps are eager, the second G and D steps capture,
the rest replay. The reference follows the first `check_steps` steps from
the same weights, batches and draws of z_rand and the reparameterisation
noise. The window runs replays alone, so the check also takes one G step
and the D step after it from the window, at a place in its first chunk
drawn from the seed: the runner's state is copied before, between and after
them, and the reference follows each from the program's state before it,
on the step's rows of the set and the generator's draws for it.
"""

import math
import time

import numpy as np
import torch

from benchmark.reference.models import init
from benchmark.reference.training import LOSSES, TRAINED, Trainer, init_adam, partition
from benchmark.yardstick.compare import leaf_norm_gaps, worst
from benchmark.yardstick.faces import faces_uint8, seeds, to_tanh

# a reference gradient under this share of the median leaf's is round-off
# (a key's bias under softmax, a BN shift that the next BN removes): Adam
# moves such a leaf by its sign, and its change is left out of the check
ROUND_OFF_GRADIENT = 1e-3


def port_cfg(run):
    from npe_tpu_torch.models import get_config

    module = get_config(run.config["model"])
    return module, {**module.cfg, **run.config["train"], "num_latents": run.config["num_latents"]}


def chunk_indices(run):
    """The next chunk's row indices into the set (host numpy): consecutive
    slices of a seeded permutation, a new one each epoch."""
    size = run.cfg["batch_size"] * run.cfg["batches_per_chunk"]
    if run.epoch_pos + size > len(run.epoch):
        run.epoch, run.epoch_pos = run.rng.permutation(run.traffic["faces"]), 0
    idx = run.epoch[run.epoch_pos:run.epoch_pos + size]
    run.epoch_pos += size
    return idx


def staged_chunk(run):
    from npe_tpu_torch.ops.kernels.staging import stage_chunk

    idx = chunk_indices(run)
    run.last_idx = idx
    return stage_chunk(run.faces, idx)


def setup(run):
    from npe_tpu_torch.training import train_step as TS
    from npe_tpu_torch.training.captured import StepRunner

    cfg, tr = run.config, run.traffic
    s_weights, s_faces, s_order, s_gen, s_check = seeds(run.seed, 5)
    run.module, run.cfg = port_cfg(run)
    run.batch = run.cfg["batch_size"]
    run.variables = init(cfg, s_weights, run.device)
    run.faces = faces_uint8(tr["faces"], s_faces, run.device)
    run.rng = np.random.default_rng(s_order)
    run.epoch, run.epoch_pos = np.zeros(0, np.int64), 0
    run.gen_seed = s_gen
    run.gen = torch.Generator(run.device).manual_seed(s_gen)
    run.lr = float(cfg["train"]["learning_rate"])
    state = TS.init_train_state(run.module, run.variables, run.cfg)
    x = staged_chunk(run)
    run.first_idx = run.last_idx
    run.runner = StepRunner(run.module, run.cfg, state, x)
    run.runner.begin(state, torch.tensor(run.lr, device=run.device))
    del state
    run.itr, run.snapshots, rows = 0, [], []
    bs, nb = run.cfg["batch_size"], run.cfg["batches_per_chunk"]
    for i in range(nb):
        rows.append(step(run, x[i * bs:(i + 1) * bs]))
        if i + 1 in (1, tr["check_steps"]):
            run.snapshots.append((i + 1, TS.copy_state(run.runner.state)))
    run.first_rows = torch.stack(rows).cpu().numpy()
    run.keys = list(run.runner.keys)
    # the window's checked pair: a G step and the D step after it, at a seeded place in its first chunk
    period = run.cfg["update_ratio"] + 1
    run.check_at = period * int(np.random.default_rng(s_check).integers(0, max(1, (nb - 1) // period)))
    run.window_states = [TS.copy_state(run.runner.state) for _ in range(3)]
    run.window_steps = []


def copy_into(dst, src):
    """Copy the nested dict of tensors `src` into `dst`, which has its shape."""
    pairs = []

    def walk(d, s):
        for k, t in d.items():
            walk(t, s[k]) if isinstance(t, dict) else pairs.append((t, s[k]))

    walk(dst, src)
    torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def step(run, xb):
    is_gen = run.itr % (run.cfg["update_ratio"] + 1) == 0
    run.itr += 1
    return run.runner.step(is_gen, xb, run.gen)


def window(run, seconds):
    """Steps until `seconds` have passed and the checked pair has run."""
    bs, nb = run.cfg["batch_size"], run.cfg["batches_per_chunk"]
    checked = (run.check_at, run.check_at + 1)
    start = time.perf_counter()
    end, steps, done = start + seconds, 0, False
    x = None
    while not done:
        del x  # one chunk on the card at a time: staging the next reuses its memory
        with run.span("stage_chunk"):
            x = staged_chunk(run)
        rows = []
        for i in range(nb):
            if steps in checked:
                k = steps - run.check_at
                if k == 0:
                    copy_into(run.window_states[0], run.runner.state)
                is_gen, draws = run.itr % (run.cfg["update_ratio"] + 1) == 0, run.gen.get_state()
            with run.span("step"):
                rows.append(step(run, x[i * bs:(i + 1) * bs]))
            if steps in checked:
                copy_into(run.window_states[k + 1], run.runner.state)
                run.window_steps.append((is_gen, run.last_idx[i * bs:(i + 1) * bs], draws, rows[-1]))
            steps += 1
            if time.perf_counter() >= end and steps > checked[1]:
                done = True
                break
        with run.span("metrics"):
            torch.stack(rows).cpu()  # the trainer reads a chunk's metrics back once
    run.window_s = time.perf_counter() - start
    run.work = steps


def release(run):
    del run.runner


def end_to_end(run):
    return {"train_imgs_per_s": run.work * run.cfg["batch_size"] / run.window_s}


def _params(state):
    return {k: t for p in TRAINED for k, t in state["parts"][p].items()}


def _moved(grads):
    """The leaves whose reference gradient is not round-off."""
    norms = {k: float(g.double().norm()) for k, g in grads.items()}
    floor = ROUND_OFF_GRADIENT * float(np.median(list(norms.values())))
    return [k for k in grads if norms[k] >= floor]


def _loss_gap(terms, want):
    return max(abs(float(terms[k]) - float(want[k])) / max(abs(float(want[k])), 1e-3) for k in LOSSES)


def _adam_of(state):
    return {p: {"count": int(state["opt"][p]["count"]), "m": state["opt"][p]["mu"], "v": state["opt"][p]["nu"]}
            for p in TRAINED}


def _variables_of(state):
    return {k: t for part in state["parts"].values() for k, t in part.items()}


def readings(run, subject):
    """The program's first check_steps steps against the reference's:
      loss    the first step's loss terms, the largest gap over the
              reference's value (the larger of it and 1e-3);
      grad    the first step's gradient as the optimizer holds it after it
              (Adam's m / (1 - beta1) of the generator and the latent
              heads), by the worst leaf;
      change  the parameters' change after check_steps steps, by the worst
              leaf, leaves whose first reference gradient is round-off left
              out.
    The later steps' losses are not compared: Adam moves every element by
    about lr whatever its gradient's size, so the float32 rounding of the
    first step's smallest gradients moves the later steps' losses by as much
    as computing in TF32 does (PERF.md, "How correct is decided").
    And the window's checked G and D steps, replays of the captured
    programs, each followed by the reference from the program's state
    before it: window_loss, window_grad (the step's gradient from Adam's m
    before and after it, (m' - beta1 m) / (1 - beta1)) and window_change
    (the step's change of the parameters), the worse of the two steps. The
    worst leaves are named for the record.
    subject "control": the reference in TF32 in the program's place;
    "half_batch": the reference on the first half of each batch's rows."""
    cfg, tr, dev = run.config, run.traffic, run.device
    bs, b1 = run.cfg["batch_size"], cfg["train"]["beta1"]
    zdim = cfg["num_latents"]
    v0 = run.variables
    x = to_tanh(run.faces[torch.from_numpy(run.first_idx).to(dev)])
    gen = torch.Generator(dev).manual_seed(run.gen_seed)
    draws = [(torch.randn((bs, zdim), generator=gen, device=dev),
              torch.randn((bs, zdim), generator=gen, device=dev)) for _ in range(tr["check_steps"])]
    ref = Trainer(cfg, "float32")
    sub = None if subject == "program" else Trainer(cfg, "tf32" if subject == "control" else "float32")
    rows = slice(0, bs // 2) if subject == "half_batch" else slice(None)

    def follow(trainer, rows=slice(None)):
        v, adam, terms, grads = dict(v0), init_adam(v0), [], []
        for i, (z_rand, noise) in enumerate(draws):
            xb = x[i * bs:(i + 1) * bs]
            v, adam, t, g = trainer.step(v, adam, xb[rows], z_rand[rows], noise[rows], run.lr, is_gen=i % 2 == 0)
            terms.append(t)
            grads.append(g)
        return v, adam, terms, grads

    v_ref, _, terms_ref, grads_ref = follow(ref)
    if sub is None:
        snap = dict(run.snapshots)
        terms = dict(zip(run.keys, run.first_rows[0]))
        first = {k: m / (1 - b1) for part in ("gen", "latent") for k, m in snap[1]["opt"][part]["mu"].items()}
        v_sub = _params(snap[tr["check_steps"]])
    else:
        v_sub, _, steps, grads = follow(sub, rows)
        terms, first = steps[0], grads[0]
    out = {"loss": _loss_gap(terms, terms_ref[0])}
    out["grad"], out["grad_leaf"] = worst(leaf_norm_gaps(first, grads_ref[0])[0])
    # the first reference gradient of each partition: the G step's, and the D step's for the discriminator
    moved = _moved({**grads_ref[0], **{k: g for k, g in grads_ref[1].items() if partition(k) == "discrim"}})
    out["change"], out["change_leaf"] = worst(leaf_norm_gaps({k: v_sub[k] - v0[k] for k in moved},
                                                             {k: v_ref[k] - v0[k] for k in moved})[0])
    window = {"window_loss": [], "window_grad": [], "window_change": []}
    for k, (is_gen, idx, state, row) in enumerate(run.window_steps):
        before, after = run.window_states[k], run.window_states[k + 1]
        v, adam = _variables_of(before), _adam_of(before)
        xb = to_tanh(run.faces[torch.from_numpy(np.ascontiguousarray(idx)).to(dev)])
        g = torch.Generator(dev)
        g.set_state(state)
        z_rand = torch.randn((bs, zdim), generator=g, device=dev)
        noise = torch.randn((bs, zdim), generator=g, device=dev)
        v_want, _, t_want, g_want = ref.step(v, adam, xb, z_rand, noise, run.lr, is_gen)
        if sub is None:
            t_got = dict(zip(run.keys, row.cpu().numpy()))
            mu0, mu1 = before["opt"], after["opt"]
            g_got = {n: (mu1[partition(n)]["mu"][n].double() - b1 * mu0[partition(n)]["mu"][n].double()) / (1 - b1)
                     for n in g_want}
            v_got = _variables_of(after)
        else:
            v_got, _, t_got, g_got = sub.step(v, adam, xb[rows], z_rand[rows], noise[rows], run.lr, is_gen)
        moved = _moved(g_want)
        window["window_loss"].append((_loss_gap(t_got, t_want), "GD"[not is_gen]))
        gap, leaf = worst(leaf_norm_gaps(g_got, g_want)[0])
        window["window_grad"].append((gap, "GD"[not is_gen] + ":" + leaf))
        gap, leaf = worst(leaf_norm_gaps({n: v_got[n] - v[n] for n in moved}, {n: v_want[n] - v[n] for n in moved})[0])
        window["window_change"].append((gap, "GD"[not is_gen] + ":" + leaf))
    for name, found in window.items():
        out[name], out[name + "_at"] = max(found, key=lambda f: f[0] if math.isfinite(f[0]) else math.inf) \
            if found else (math.inf, "not run")
    return out


def unit_flops(run):
    """Operations of one step, the mean of a G and a D step of the reference
    at the configuration's batch, counted on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, bs = run.config, run.cfg["batch_size"]
    v = {k: torch.empty(t.shape, device="meta") for k, t in run.variables.items()}
    x = torch.empty((bs, *cfg["image"]), device="meta")
    z = torch.empty((bs, cfg["num_latents"]), device="meta")
    trainer = Trainer(cfg)
    total = 0
    for is_gen in (True, False):
        with FlopCounterMode(display=False) as counter:
            trainer.step(v, init_adam(v), x, z, z, run.lr, is_gen)
        total += counter.get_total_flops()
    return total / 2
