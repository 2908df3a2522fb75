"""Encode+decode throughput of npe_tpu_torch on one NVIDIA GPU (the port's
counterpart of bench.py's headline metrics).

For each model and form -- IAN_simple; IANv1 with the RGB-Beta head in the
hybrid and the fused form; full IAN with its MDBLOCKs in the per-op and the
fused form -- it times encode+decode of a batch in images per second. As in
bench.py, the default is bench.py's headline configuration, the bf16 inference
path at batch 256 (`--dtype float32` for the other), and one timed round
chains `--iters` dependent passes, y = decode(encode(0.9 y + 0.1 x)), so no
pass can overlap or be skipped; a round is timed by CUDA events. Every figure
is the median of `--repeats` rounds, with the rounds and their spread beside
it.

`mfu` is the achieved rate over the card's peak for the dtype (H100 SXM,
NVIDIA's data sheet: 989 TFLOP/s dense bf16 on the tensor cores; 67 TFLOP/s
float32 outside them, TF32 being off). The operations per image are counted
from the port's own model by `torch.utils.flop_counter.FlopCounterMode`, over
one encode+decode of one image on the CPU in float32 (the count does not
depend on the dtype or the batch). The counter sees library calls only, so a
hand kernel counts as what its plain version computes there: exactly the
kernel's products for `mdblock_fused` and `rgb_beta_tail`; for the fused head
its dense trunk conv, 81 offsets where the kernel takes 33.

Weights are seeded random draws (throughput does not depend on their values).
chip_smoke.py imports `encode_decode_rate`, so its figures come from this code.

Usage: python3 bench_torch.py [--dtype bfloat16|float32] [--batch 256] [--iters 10]
           [--repeats 5] [--models IAN_simple,IANv1,IAN]
Prints one JSON line. Exits nonzero without a CUDA device.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

BASELINE_IMGS_PER_S = 5000.0  # BASELINE.md's floor, kept as the port's (PERF.md section 2)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
# (model, its forms as decode keywords)
FORMS = (("IAN_simple", {}), ("IANv1", {"head_mode": "hybrid"}), ("IANv1", {"head_mode": "fused"}),
         ("IAN", {"mdblock_mode": "plain"}), ("IAN", {"mdblock_mode": "fused"}))


def form_label(model, options):
    return " ".join([model] + [f"{k}={v}" for k, v in options.items()])


def flops_per_image(module, variables_cpu, options):
    """Operations of one encode+decode of one image, counted by
    FlopCounterMode on the CPU (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros((1, 3, 64, 64), dtype=next(iter(variables_cpu.values())).dtype)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module.decode(variables_cpu, module.encode(variables_cpu, x), **options)
    return counter.get_total_flops()


def encode_decode_rate(module, variables, x, iters, repeats, options):
    """imgs/s of encode+decode of the batch x, `repeats` rounds of `iters`
    chained passes each, after one warm round: (median imgs/s, the rounds'
    ms, spread (max - min) / median of the rounds' times)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def chain():
        y = x
        for _ in range(iters):
            y = module.decode(variables, module.encode(variables, 0.9 * y + 0.1 * x), **options)
        return y

    with torch.no_grad():
        y = chain()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y).all()), "encode+decode gave a value that is not finite"
        rounds = []
        for _ in range(repeats):
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize()
            rounds.append(start.elapsed_time(end))
    ms = float(np.median(rounds))
    return x.shape[0] * iters / ms * 1e3, rounds, (max(rounds) - min(rounds)) / ms


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", default="bfloat16", choices=sorted(PEAK_FLOPS))
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=10, help="chained encode+decode passes a timed round")
    p.add_argument("--repeats", type=int, default=5, help="timed rounds; the median is reported")
    p.add_argument("--models", default="IAN_simple,IANv1,IAN",
                   help="comma-separated; each runs in all of its forms")
    a = p.parse_args(argv)
    models = a.models.split(",")
    unknown = sorted(set(models) - {m for m, _ in FORMS})
    if unknown or a.batch < 1 or a.iters < 1 or a.repeats < 1:
        p.error(f"unknown models {unknown}" if unknown else "--batch, --iters and --repeats must be positive")
    a.forms = [(m, o) for m, o in FORMS if m in models]
    return a


def main(argv=None):
    a = parse(argv)
    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.utils.cast import cast_floating

    dtype = getattr(torch, a.dtype)
    x = (torch.randn((a.batch, 3, 64, 64), generator=torch.Generator().manual_seed(1)) * 0.5).cuda().to(dtype)
    results = []
    for model in dict.fromkeys(m for m, _ in a.forms):
        module = get_config(model)
        variables_cpu = module.init(torch.Generator().manual_seed(0), "cpu")
        variables = cast_floating({k: v.cuda() for k, v in variables_cpu.items()}, dtype)
        for _, options in (f for f in a.forms if f[0] == model):
            flops = flops_per_image(module, variables_cpu, options)
            rate, rounds, spread = encode_decode_rate(module, variables, x, a.iters, a.repeats, options)
            results.append({"model": model, "form": options, "imgs_per_s": rate, "rounds_ms": rounds,
                            "spread_frac": spread, "vs_baseline": rate / BASELINE_IMGS_PER_S,
                            "flops_per_img": flops, "mfu": rate * flops / PEAK_FLOPS[a.dtype]})
            print(f"{form_label(model, options)}: {rate:.1f} imgs/s (spread {spread:.3f})", file=sys.stderr)
        del variables
    print(json.dumps({"metric": "encode_decode_throughput", "unit": "imgs/s", "dtype": a.dtype, "batch": a.batch,
                      "iters": a.iters, "repeats": a.repeats, "results": results,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
