"""Sweep of a hand kernel over the one launch parameter its wrapper picks,
on one NVIDIA GPU (Hopper), from the root of the repository:

    python3 scripts/kernel_sweep.py mdblock plan          # `mdblock.fwd_plan`
    python3 scripts/kernel_sweep.py rgb_beta_tail rows    # `rgb_beta_tail.tail_rows`
    python3 scripts/kernel_sweep.py rgb_beta_head slices  # `rgb_beta_head.head_slices`
    python3 scripts/kernel_sweep.py mdblock_bwd plan      # `mdblock.bwd_plan`

- mdblock: the float32 forward's plan at full IAN's three block shapes and
  two narrow ones: at batch 1, 2 and 8 every cut of the units into slices
  and clusters whose blocks fit the SMs once; at batch 128 every number of
  stages that fits, with halo tiles (one patch a block or two) and with a
  window a unit;
- rgb_beta_tail: the cell rows a block computes, 1 to 16 (16: a block holds
  the whole image), at a 16x16 cell map, batch 1 to 128;
- rgb_beta_head: the trunk's channel slices (its launch, and the pass that
  adds them), 1 to 8, at C 64 (IANv1) batch 1 to 128 and C 128 (full IAN);
- mdblock_bwd: the backward's plan, float32 and bf16, at full IAN's three
  shapes: at batch 1, 2 and 8 every cut of the units into slices and
  clusters whose blocks fit the SMs once (those past the card's cluster
  slots, which it prints first, run in two waves); at batch 128 every
  sub_tiles, tile_channels, halo_buffers and stages that fits (float32:
  one patch a block, 128 channels, two halo buffers). Each is held
  to `mdblock_backward_reference` (float32 within MDBLOCK_BWD_TOL of the
  largest value, bf16 within BF16_POINTS + 1 steps: its error is the worst
  fraction of that rule).

It builds the kernel's source (printing nvcc's register, shared-memory and
spill report), holds the kernel at every value against its plain version
(chip_smoke.py's KERNEL_TOL, HEAD_TOL, MDBLOCK_TOL) and times it by
CUDA-graph replay, beside the value the wrapper picks, the wrapper and, at
small batches, the plain version. It is the evidence for each wrapper's
rule; chip_smoke.py and scripts/kernel_ab.py hold the kernels' times on the
main path's shapes.
"""

import ctypes
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, ".")
from chip_smoke import (BF16_POINTS, BF16_STEP, HEAD_TOL, KERNEL_TOL, MDBLOCK_BWD_TOL, MDBLOCK_TOL,  # noqa: E402
                        mdblock_inputs)
from npe_tpu_torch.ops.kernels import build  # noqa: E402
from npe_tpu_torch.ops.kernels import mdblock as mk  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_head as rh  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt  # noqa: E402
from npe_tpu_torch.utils.timing import graph_ms  # noqa: E402

PARAMETER = {"mdblock": "plan", "rgb_beta_tail": "rows", "rgb_beta_head": "slices", "mdblock_bwd": "plan"}
MDBLOCK_SHAPES = ((512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3)), (16, 8, (0, 2)), (32, 16, (0, 2, 3)))
HEAD_SCALES = (2, 3, 4)


def tensor(rng, shape, scale, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def mdblock_cases(dev, sms):
    for c, size, scales in MDBLOCK_SHAPES:
        radius = max(mk.dilations(scales))
        for batch in (1, 2, 8, 128):
            if batch == 128 and c < 128:
                continue
            x, t1, t2, aff = mdblock_inputs(batch, c, size, scales, 60 + batch, dev)
            pick = mk.fwd_plan(batch, c, size, size, scales, sms)
            if batch < 128:
                units = -(-c * 4 // mk.BWD_CHUNK_BYTES) * 9 * len(mk.dilations(scales))
                tiles = batch * (size // 8) ** 2 * -(-c // mk.TILE_CHANNELS)
                values = [pick._replace(splits=s, cluster=n) for s in range(1, 34) for n in range(1, 9)
                          if s % n == 0 and units // s >= mk.BWD_MIN_UNITS and tiles * s <= sms]
            else:
                values = [mk.FwdPlan(halo, sub, st, 1, 1, mk.fwd_smem_bytes(halo, st, radius, sub))
                          for halo in (True, False) for sub in ((1, 2) if halo else (1,)) for st in range(3, 8)
                          if mk.fwd_smem_bytes(halo, st, radius, sub) <= mk.SMEM_PER_BLOCK]
            values = list(dict.fromkeys(values + [pick]))

            def run(plan, args=(x, t1, t2, aff, scales)):
                """The float32 forward on a plan of the caller's choice."""
                out, _, rc = mk._launch_float32(*args, keep_h1=False, plan=plan)
                assert rc == 0, rc
                return out

            plain = lambda x=x, t1=t1, t2=t2, aff=aff, s=scales: mk.mdblock_taps_reference(x, t1, t2, aff, s)  # noqa: E731
            others = {"wrapper": lambda x=x, t1=t1, t2=t2, aff=aff, s=scales: mk.mdblock_fused(x, t1, t2, aff, s)}
            if batch <= 8:
                others["plain"] = plain
            yield (f"C {c} {size}x{size} batch {batch}", run, plain(), MDBLOCK_TOL, values, pick, others,
                   5 if batch == 128 else 20, 4 if batch == 128 else 10)


def rgb_beta_tail_cases(dev, sms, h=16, w=16):
    for batch in (1, 8, 16, 64, 128):
        rng = np.random.RandomState(batch)
        trunk = tensor(rng, (batch, 6 * rt.RR, h, w), 1.0, dev)
        tg = tensor(rng, (9, 32, 32), 1 / np.sqrt(9 * 32 / 4), dev)
        tb = tensor(rng, (9, 64, 32), 1 / np.sqrt(9 * 64 / 4), dev)

        def run(rows, trunk=trunk, tg=tg, tb=tb):
            """The kernel's C entry point with a row count of the caller's choice."""
            out = torch.empty((trunk.shape[0], 3 * rt.RR, h, w), device=trunk.device)
            rc = rt._entry(False)(trunk.data_ptr(), tg.data_ptr(), tb.data_ptr(), out.data_ptr(), trunk.shape[0], h, w,
                             rows, torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
            return out

        plain = lambda trunk=trunk, tg=tg, tb=tb: rt.rgb_beta_tail_reference(trunk, tg, tb)  # noqa: E731
        others = {"wrapper": lambda trunk=trunk, tg=tg, tb=tb: rt.rgb_beta_tail(trunk, tg, tb), "plain": plain}
        yield (f"{h}x{w} cells batch {batch}", run, plain(), KERNEL_TOL, [1, 2, 4, 8, 16],
               rt.tail_rows(batch, h, w, sms), others, 20, 10)


def rgb_beta_head_cases(dev, sms):
    for c, batch in ((64, 1), (64, 2), (64, 4), (64, 8), (64, 16), (64, 128), (128, 1), (128, 2)):
        rng = np.random.RandomState(c + batch)
        x = tensor(rng, (batch, c, 64, 64), 1.0, dev)
        tr = tensor(rng, (36, c, 6), 1 / np.sqrt(33 * c), dev)
        want = F.pixel_unshuffle(mk._mdcl_taps(x, tr, mk.tap_offsets(HEAD_SCALES)), 4)
        yield (f"trunk C {c} batch {batch}", lambda s, x=x, tr=tr: rh.trunk_only(x, tr, HEAD_SCALES, s), want,
               HEAD_TOL, list(range(1, rh.MAX_SLICES + 1)), rh.head_slices(batch, 64 // rh.BAND_ROWS, c, sms), {},
               5 if batch == 128 else 50, 10)


def bwd_rule(bf16):
    """The backward's error as a fraction of its rule (1 is the limit)."""
    def error(got, want):
        g, w = got.double(), want.double()
        if bf16:
            return float(((g - w).abs() / ((BF16_POINTS + 1) * BF16_STEP * (w.abs() + w.std()))).max())
        return float((g - w).abs().max()) / (MDBLOCK_BWD_TOL * float(w.abs().max()))
    return error


def mdblock_bwd_cases(dev, sms):
    lib = build.load("mdblock_bwd")
    slots = lib.npe_mdblock_bwd_clusters
    slots.argtypes = [ctypes.c_int] * 5
    for bf16 in (0, 1):
        stages = mk.BWD_STAGES[bool(bf16)][1]
        print(f"[sweep] mdblock_bwd {'bf16' if bf16 else 'float32'}: clusters the card holds at once, one block an "
              f"SM, by cluster size: {({n: slots(bf16, stages, 2, 3, n) for n in range(1, 9)})} (the plan's "
              f"CLUSTER_SLOTS: {mk.CLUSTER_SLOTS})", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for c, size, scales in MDBLOCK_SHAPES[:3]:
            for batch in (1, 2, 8, 128):
                x, t1, t2, aff = (t.to(dtype) if i < 3 else t
                                  for i, t in enumerate(mdblock_inputs(batch, c, size, scales, 60 + batch, dev)))
                g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(batch), device=dev).to(dtype)
                y, h1, _ = (mk._launch_bf16 if bf16 else mk._launch_float32)(x, t1, t2, aff, scales)
                h1_nchw = h1.permute(0, 3, 1, 2) if bf16 else h1
                want = mk.mdblock_backward_reference(g, x, y, h1_nchw, t1, t2, aff, scales)
                pick = mk.bwd_plan(batch, c, size, size, scales, dtype, sms)
                radius = max(mk.dilations(scales))
                if batch < 128:
                    units = -(-c * (2 if bf16 else 4) // mk.BWD_CHUNK_BYTES) * 9 * len(mk.dilations(scales))
                    tiles = batch * (size // 8) ** 2 * -(-c // pick.tile_channels)
                    values = [pick._replace(splits=s, cluster=n) for s in range(1, 34) for n in range(1, 9)
                              if s % n == 0 and units // s >= mk.BWD_MIN_UNITS and tiles * s <= sms]
                else:
                    values = [mk.BwdPlan(sub, tile, st, hb, 1, 1, mk.bwd_smem_bytes(bf16, sub, st, hb, radius, tile))
                              for sub in ((1, 2) if bf16 else (1,))
                              for tile in ((128, 256) if sub == 2 and c >= 256 else (128,))
                              for hb in ((2, 1) if bf16 else (2,)) for st in range(3, 9)
                              if mk.bwd_smem_bytes(bf16, sub, st, hb, radius, tile) <= mk.SMEM_PER_BLOCK]
                values = list(dict.fromkeys(values + [pick]))

                def run(plan, args=(g, x, y, h1, t1, t2, aff, scales)):
                    dx, rc = mk._launch_bwd(*args, plan=plan)
                    assert rc == 0, rc
                    return dx

                yield (f"{'bf16' if bf16 else 'float32'} {size}x{size}x{c} batch {batch}", run, want, 1.0, values,
                       pick, {}, 5 if batch == 128 else 20, 4 if batch == 128 else 10)


def plan_name(v):
    """A value of the sweep as printed: a plan's fields, or itself."""
    if isinstance(v, mk.FwdPlan):
        return f"({'halo' if v.halo else 'windows'}, sub {v.sub_tiles}, {v.stages} st, {v.splits}/{v.cluster})"
    if isinstance(v, mk.BwdPlan):
        return (f"(sub {v.sub_tiles}, {v.tile_channels} ch, {v.stages} st, {v.halo_buffers} halo, "
                f"{v.splits}/{v.cluster})")
    return str(v)


def main():
    if len(sys.argv) != 3 or PARAMETER.get(sys.argv[1]) != sys.argv[2]:
        print("kernel_sweep: give a kernel and its parameter: "
              + ", ".join(f"{k} {p}" for k, p in PARAMETER.items()), file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    kernel, parameter = sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain versions in float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    for line in build.build(kernel).splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] {kernel}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {"mdblock": mdblock_cases, "rgb_beta_tail": rgb_beta_tail_cases, "rgb_beta_head": rgb_beta_head_cases,
             "mdblock_bwd": mdblock_bwd_cases}[kernel](dev, sms)
    error = (lambda label: bwd_rule("bf16" in label)) if kernel == "mdblock_bwd" else (
        lambda label: lambda got, want: float((got - want).abs().max()))
    with torch.no_grad():
        for label, run, want, tol, values, pick, others, iters, reps in cases:
            times, worst = {}, 0.0
            for v in values:
                err = error(label)(run(v), want)
                assert err <= tol, f"{kernel} {label}, {parameter} {v}: max abs err {err} > {tol}"
                worst = max(worst, err)
                times[v] = graph_ms(lambda: run(v), iters=iters, reps=reps)  # noqa: B023
            best = min(times, key=times.get)
            ranked = sorted(times, key=times.get) if kernel in ("mdblock", "mdblock_bwd") else times
            line = (f"[sweep] {kernel} {label}: "
                    + ", ".join(f"{plan_name(v)} {parameter} {times[v]:.5f} ms" for v in ranked)
                    + f"; best {plan_name(best)}, the wrapper picks {plan_name(pick)} "
                    + f"({times[pick] / times[best]:.3f}x the best)"
                    + "".join(f"; {name} {graph_ms(fn, iters=iters, reps=reps):.5f} ms" for name, fn in others.items())
                    + f"; max {'fraction of the rule' if kernel == 'mdblock_bwd' else 'abs err'} vs plain "
                    + f"{worst:.3e} ({smi})")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
