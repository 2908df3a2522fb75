"""Sweep of a hand kernel over the one launch parameter its wrapper picks,
on one NVIDIA GPU (Hopper), from the root of the repository:

    python3 scripts/kernel_sweep.py mdblock slices        # `mdblock.inner_splits`
    python3 scripts/kernel_sweep.py rgb_beta_tail rows    # `rgb_beta_tail.tail_rows`
    python3 scripts/kernel_sweep.py rgb_beta_head slices  # `rgb_beta_head.head_slices`

- mdblock: the slices the inner dimension is cut into, at full IAN's three
  block shapes, batch 1, 8 and 128, every count that gives between 100
  blocks and twelve a multiprocessor; two narrow shapes at the wrapper's
  count only;
- rgb_beta_tail: the cell rows a block computes, 1 to 16 (16: a block holds
  the whole image), at a 16x16 cell map, batch 1 to 128;
- rgb_beta_head: the trunk's channel slices (its launch, and the pass that
  adds them), 1 to 8, at C 64 (IANv1) batch 1 to 128 and C 128 (full IAN).

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
from chip_smoke import HEAD_TOL, KERNEL_TOL, MDBLOCK_TOL  # noqa: E402
from npe_tpu_torch.ops.kernels import build  # noqa: E402
from npe_tpu_torch.ops.kernels import mdblock as mk  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_head as rh  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt  # noqa: E402
from npe_tpu_torch.utils.timing import graph_ms  # noqa: E402

PARAMETER = {"mdblock": "slices", "rgb_beta_tail": "rows", "rgb_beta_head": "slices"}
MDBLOCK_SHAPES = ((512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3)), (16, 8, (0, 2)), (32, 16, (0, 2, 3)))
HEAD_SCALES = (2, 3, 4)


def tensor(rng, shape, scale, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def mdblock_cases(dev, sms):
    for c, size, scales in MDBLOCK_SHAPES:
        for batch in (1, 8, 128):
            if batch == 128 and c < 128:
                continue
            rng = np.random.RandomState(c + batch)
            br = mk.dilations(scales)
            n_taps = 9 * len(br)
            x = tensor(rng, (batch, c, size, size), 1.0, dev)
            t1, t2 = (tensor(rng, (n_taps, c, c), 1 / np.sqrt(2.2 * c), dev) for _ in range(2))
            aff = torch.from_numpy(np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3)
                                   .astype(np.float32)).to(dev)
            units = n_taps * c // mk.CHANNEL_STEP
            tiles = (size * size // mk.TILE_PIXELS) * -(-c // mk.TILE_CHANNELS)
            pick = mk.inner_splits(batch, tiles, units, sms)
            values = [pick]
            if c >= 128:
                values = [d for d in range(1, 145) if units % d == 0
                          and (100 <= d * tiles * batch <= 12 * sms or d == pick)]

            def run(splits, x=x, t1=t1, t2=t2, aff=aff, br=br):
                """The kernel's float32 C entry point with a slice count of the caller's choice."""
                h1, out = torch.empty_like(x), torch.empty_like(x)
                partial = x.new_empty((x.shape[0], splits) + x.shape[1:]) if splits > 1 else None
                rc = mk._entry(False)(x.data_ptr(), t1.data_ptr(), t2.data_ptr(), aff.data_ptr(), h1.data_ptr(),
                                 None if partial is None else partial.data_ptr(), out.data_ptr(), *x.shape,
                                 len(br), (ctypes.c_int * len(br))(*br), splits,
                                 torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
                return out

            plain = lambda x=x, t1=t1, t2=t2, aff=aff, s=scales: mk.mdblock_taps_reference(x, t1, t2, aff, s)  # noqa: E731
            others = {"wrapper": lambda x=x, t1=t1, t2=t2, aff=aff, s=scales: mk.mdblock_fused(x, t1, t2, aff, s)}
            if batch <= 8:
                others["plain"] = plain
            yield f"C {c} {size}x{size} batch {batch}", run, plain(), MDBLOCK_TOL, values, pick, others, 10, 5


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
    cases = {"mdblock": mdblock_cases, "rgb_beta_tail": rgb_beta_tail_cases,
             "rgb_beta_head": rgb_beta_head_cases}[kernel](dev, sms)
    with torch.no_grad():
        for label, run, want, tol, values, pick, others, iters, reps in cases:
            times, worst = {}, 0.0
            for v in values:
                err = float((run(v) - want).abs().max())
                assert err <= tol, f"{kernel} {label}, {parameter} {v}: max abs err {err} > {tol}"
                worst = max(worst, err)
                times[v] = graph_ms(lambda: run(v), iters=iters, reps=reps)  # noqa: B023
            best = min(times, key=times.get)
            line = (f"[sweep] {kernel} {label}: " + ", ".join(f"{v} {parameter} {t:.5f} ms" for v, t in times.items())
                    + f"; best {best}, the wrapper picks {pick} ({times[pick] / times[best]:.3f}x the best)"
                    + "".join(f"; {name} {graph_ms(fn, iters=iters, reps=reps):.5f} ms" for name, fn in others.items())
                    + f"; max abs err vs plain {worst:.3e} ({smi})")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
