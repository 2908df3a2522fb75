"""Sweep of the `mdblock_fused` kernel over the number of slices its inner
dimension is cut into, on one NVIDIA GPU (Hopper):

    python3 scripts/mdblock_sweep.py        # from the root of the repository

Builds `npe_tpu_torch/csrc/mdblock.cu` (printing nvcc's register and shared
memory report), checks the kernel against its plain version at full IAN's
three block shapes and two narrow ones, batch 1, 8 and 128, and times it by
CUDA-graph replay at every slice count that gives between 100 blocks and
twelve per multiprocessor, beside the count the wrapper picks
(`ops.kernels.mdblock.inner_splits`) and the plain version. It is the
evidence for that function's rule; chip_smoke.py holds the kernel's times at
the main path's shapes.
"""

import ctypes
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
from npe_tpu_torch.ops.kernels import build, mdblock as mk  # noqa: E402
from npe_tpu_torch.utils.timing import graph_ms  # noqa: E402

SHAPES = ((512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3)), (16, 8, (0, 2)), (32, 16, (0, 2, 3)))


def run_with(x, t1, t2, aff, scales, splits):
    """The kernel's C entry point with a slice count of the caller's choice."""
    n, c, h, w = x.shape
    br = mk.dilations(scales)
    h1, out = torch.empty_like(x), torch.empty_like(x)
    partial = x.new_empty((n, splits, c, h, w)) if splits > 1 else None
    rc = mk._entry()(x.data_ptr(), t1.data_ptr(), t2.data_ptr(), aff.data_ptr(), h1.data_ptr(),
                     None if partial is None else partial.data_ptr(), out.data_ptr(), n, c, h, w, len(br),
                     (ctypes.c_int * len(br))(*br), splits, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def main():
    if not torch.cuda.is_available():
        print("mdblock_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    print("\n".join(line for line in build.build("mdblock").splitlines() if "Used" in line or "spill" in line))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    us = lambda fn: round(graph_ms(fn, iters=10, reps=5) * 1e3, 1)  # noqa: E731
    for c, size, scales in SHAPES:
        for batch in (1, 8, 128):
            if batch == 128 and c < 128:
                continue
            rng = np.random.RandomState(c + batch)
            n_taps = 9 * len(mk.dilations(scales))
            x = torch.from_numpy(rng.randn(batch, c, size, size).astype(np.float32)).to(dev)
            t1, t2 = (torch.from_numpy((rng.randn(n_taps, c, c) / np.sqrt(2.2 * c)).astype(np.float32)).to(dev)
                      for _ in range(2))
            aff = torch.from_numpy(
                np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3).astype(np.float32)).to(dev)
            got = mk.mdblock_fused(x, t1, t2, aff, scales)
            torch.cuda.synchronize()
            want = mk.mdblock_taps_reference(x, t1, t2, aff, scales)
            line = (f"C {c} {size}x{size} batch {batch}: max abs err {float((got - want).abs().max()):.3e}, "
                    f"output std {float(want.std()):.3f}")
            if c >= 128:
                units = n_taps * c // mk.CHANNEL_STEP
                tiles = (size * size // mk.TILE_PIXELS) * -(-c // mk.TILE_CHANNELS)
                times = {}
                with torch.no_grad():
                    for d in (d for d in range(1, 145) if units % d == 0):
                        if 100 <= d * tiles * batch <= 12 * sms or d == 1 == mk.inner_splits(batch, tiles, units, sms):
                            assert float((run_with(x, t1, t2, aff, scales, d) - want).abs().max()) < 1e-3
                            times[d] = us(lambda: run_with(x, t1, t2, aff, scales, d))
                    line += (f"; us by slices {times}; wrapper ({mk.inner_splits(batch, tiles, units, sms)} slices) "
                             f"{us(lambda: mk.mdblock_fused(x, t1, t2, aff, scales))} us")
                    if batch <= 8:
                        line += f"; plain {us(lambda: mk.mdblock_taps_reference(x, t1, t2, aff, scales))} us"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
