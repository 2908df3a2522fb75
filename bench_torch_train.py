#!/usr/bin/env python
"""Training-step throughput of npe_tpu_torch on one NVIDIA GPU: the port's
counterpart of bench_train.py. Alternating G + D steps (the reference's hot
loop, `train_IAN.py:493-509`) on device-resident data, in imgs/s.

The steps are the trainer's captured programs (`training/captured.py`, a
`StepRunner`: one CUDA graph for the G step and one for the D step, the
counterpart of bench_train.py's one jitted scan over G + D pairs). The same
batch x and sample latents z go into every step, as in bench_train.py; the
reparameterization noise is drawn anew for each step from a generator on the
card, outside the graphs, as the trainer draws it. One warm round runs the
first G and D step eagerly and captures the second of each; every timed round
replays `--pairs` G + D pairs between two CUDA events and then reads the sum
of the D steps' pixel losses to the host, which must be finite (bench_train's
checksum). Rounds are collected by bench_train.py's settle loop: until
`--rounds` of them agree within 30 % of the fastest, at most 2 * rounds + 2
(the discarded ones are reported, and `contended` is set when as many were
discarded as kept); the median is reported.

`lr` is a runtime scalar of the captured steps (a 0-d tensor on the card:
the same program at any rate). Full IAN on these noise inputs goes
non-finite at any lr > 0 after a few hundred pairs (docs/NUMERICS.md: the
frozen IAF's exp-division overflows once training has drifted ls_bnorm's
scale); --lr 0 pins the parameters and measures the same program.

`mfu` is the rate over the card's peak for the compute dtype
(`bench_torch.PEAK_FLOPS`: H100 SXM, 989 TFLOP/s dense bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, TF32 being off). The operations are
the port's own: one G step and one D step counted by
`torch.utils.flop_counter.FlopCounterMode` on the CPU in float32 at batch 2,
per image and step (the count per image does not depend on the batch or the
dtype). The counter sees library calls only, so the RGB-Beta tail kernel
counts as its plain version's products.

Usage: python3 bench_torch_train.py [--model IAN_simple] [--batch 128] [--pairs 15] [--rounds 5]
           [--compute-dtype bfloat16] [--moments-dtype bfloat16] [--lr 2e-4]
Prints ONE JSON line. Exits nonzero without a CUDA device.
"""

import argparse
import functools
import json
import math
import sys

import torch

from bench_torch import PEAK_FLOPS, nvidia_smi


@functools.cache
def flops_per_image(model, batch=2):
    """Operations of one G step and one D step of `model` at its cfg, per
    image and step: counted by FlopCounterMode on the CPU in float32 over
    seeded weights at `batch` (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.training import train_step as TS

    module = get_config(model)
    cfg = dict(module.cfg, batch_size=batch)
    state = TS.init_train_state(module, module.init(torch.Generator().manual_seed(0), "cpu"), cfg)
    x, z = torch.zeros((batch, 3, 64, 64)), torch.zeros((batch, cfg["num_latents"]))
    total = 0
    for step in TS.make_train_steps(module, cfg):
        with FlopCounterMode(display=False) as counter:
            state, _ = step(state, x, z, z, 0.0)
        total += counter.get_total_flops()
    return total / (2 * batch)


def run(model="IAN_simple", batch=128, pairs=15, rounds=5, compute_dtype=None, lr=2e-4, moments_dtype=None):
    """bench_train.py's measurement on the card; returns its JSON object
    (and the card's name, nvidia-smi's name and power limit, the operations
    per image and step behind `mfu` and the peak device memory)."""
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.training import train_step as TS
    from npe_tpu_torch.training.captured import StepRunner

    module = get_config(model)
    cfg = dict(module.cfg, batch_size=batch)
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    if moments_dtype:
        cfg["moments_dtype"] = moments_dtype
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_train_state(module, module.init(torch.Generator().manual_seed(0), "cuda"), cfg)
    # tanh keeps the fake images strictly inside (-1, 1), the range real data
    # occupies (`to_tanh`, reference `train_IAN.py:35-40`)
    x = torch.tanh(torch.randn((batch, 3, 64, 64), generator=torch.Generator().manual_seed(1)) * 0.5).cuda()
    z = torch.randn((batch, cfg["num_latents"]), generator=torch.Generator().manual_seed(2)).cuda()
    runner = StepRunner(module, cfg, state, x)
    runner.begin(state, lr)
    del state
    runner.x.copy_(x)
    runner.z_rand.copy_(z)
    gen = torch.Generator("cuda").manual_seed(10)

    def chained():
        pixel_losses = []
        for _ in range(pairs):
            for is_gen in (True, False):
                torch.randn(runner.noise.shape, generator=gen, out=runner.noise)
                row = runner.run(is_gen)
            pixel_losses.append(row[runner.keys.index("pixel_loss")])
        return torch.stack(pixel_losses).sum()

    while any(p.graph is None for p in runner.programs.values()):  # warm: eager steps, then the captures
        checksum = float(chained())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times, discarded = [], []
    for _ in range(2 * rounds + 2):
        start.record()
        s = chained()
        end.record()
        checksum = float(s)
        times.append(start.elapsed_time(end) / 1e3)
        fastest = min(times)
        good = [t for t in times if t <= 1.3 * fastest]
        if len(good) >= rounds:
            discarded = sorted(t for t in times if t > 1.3 * fastest)
            times = sorted(good)
            break
    else:
        times.sort()
    if not math.isfinite(checksum):
        raise FloatingPointError(f"{model}: the D steps' pixel losses summed to {checksum} (docs/NUMERICS.md; --lr 0)")
    dt = times[len(times) // 2]
    n_steps = 2 * pairs
    imgs_per_sec = batch * n_steps / dt
    flops = flops_per_image(model)
    return {
        "metric": f"{model.lower()}_train_step_throughput"
        + (f"_{compute_dtype}" if compute_dtype else "")
        + ("_bf16moments" if moments_dtype else ""),
        "value": imgs_per_sec,
        "unit": "imgs/sec/chip",
        "compute_dtype": compute_dtype or "float32",
        "moments_dtype": moments_dtype or "float32",
        "batch": batch,
        "ms_per_step": dt / n_steps * 1e3,
        "spread_frac": (times[-1] - times[0]) / dt,
        "round_times_s": times,
        "discarded_round_times_s": discarded,
        # the settle loop keeps rounds within 1.3x of the fastest, which
        # favours the median under persistent contention
        "contended": len(discarded) >= len(times),
        "rounds": len(times),
        "mfu": imgs_per_sec * flops / PEAK_FLOPS[compute_dtype or "float32"],
        "flops_per_img_step": flops,
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(),
    }


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="IAN_simple", choices=["IAN_simple", "IANv1", "IAN"])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--pairs", type=int, default=15, help="G+D step pairs per round")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--compute-dtype", default=None, choices=[None, "float32", "bfloat16"],
                   help="mixed-precision compute dtype (bfloat16); master weights stay float32")
    p.add_argument("--lr", type=float, default=2e-4, help="see the module docstring: the same program at any rate")
    p.add_argument("--moments-dtype", default=None,
                   help="Adam m/v storage dtype (e.g. bfloat16); update math stays f32")
    a = p.parse_args(argv)
    if a.batch < 1 or a.pairs < 1 or a.rounds < 1:
        p.error("--batch, --pairs and --rounds must be positive")
    return a


def main(argv=None):
    a = parse(argv)
    if not torch.cuda.is_available():
        print("bench_torch_train: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run(model=a.model, batch=a.batch, pairs=a.pairs, rounds=a.rounds,
                         compute_dtype=a.compute_dtype, lr=a.lr, moments_dtype=a.moments_dtype)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
