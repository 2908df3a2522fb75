"""The RGB-Beta head's backward kernels pass by pass, on the card.

    python3 scripts/rgb_beta_bwd_passes.py          # from the root of the repository

Runs the tail's backward (`rgb_beta_tail._launch_bwd`: float32 and bf16, at
batch 1, 16 and 128, with and without the taps' gradients) and x's gradient
of the fused head (`rgb_beta_head._launch_bwd`, C = 64 and 128) under
torch.profiler, and prints each device kernel's mean time a call, and the
whole call's device time by CUDA-graph replay, with the card's name and power
limit. Inputs are seeded, as chip_smoke.py's. Needs one CUDA device.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from npe_tpu_torch.ops.kernels import rgb_beta_head as rh  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt  # noqa: E402
from npe_tpu_torch.utils.timing import graph_ms  # noqa: E402

SCALES = (2, 3, 4)
CALLS = 20


def tail_inputs(batch, dtype, trunk_dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    trunk = torch.from_numpy(rng.randn(batch, 96, 16, 16).astype(np.float32)).to(dev, trunk_dtype)
    tg = torch.from_numpy((rng.randn(9, 32, 32) / np.sqrt(72)).astype(np.float32)).to(dev, dtype)
    tb = torch.from_numpy((rng.randn(9, 64, 32) / np.sqrt(144)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(batch, 48, 16, 16).astype(np.float32)).to(dev, dtype)
    return trunk, tg, tb, g


def head_inputs(batch, channels, dtype, dev, seed=1):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, channels, 64, 64).astype(np.float32)).to(dev, dtype)
    tr = (rng.randn(36, channels, 6) / np.sqrt(33 * channels)).astype(np.float32)
    tr = torch.from_numpy(tr).to(dev, dtype)
    tg = torch.from_numpy((rng.randn(9, 32, 32) / np.sqrt(72)).astype(np.float32)).to(dev, dtype)
    tb = torch.from_numpy((rng.randn(9, 64, 32) / np.sqrt(144)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(batch, 3, 64, 64).astype(np.float32)).to(dev, dtype)
    return x, tr, tg, tb, g


def passes(label, fn):
    """fn() CALLS times under the profiler: each device kernel's mean time a
    call; then fn's device time by CUDA-graph replay."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / CALLS / 1e3
    print(f"{label}: graph {graph_ms(fn, iters=20):.5f} ms; profiler {total:.5f} ms a call:", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / CALLS / 1e3
        print(f"    {ms:9.5f} ms  {e.count / CALLS:4.1f}x  {e.key[:110]}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("rgb_beta_bwd_passes: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 16, 128):
            for taps in (False, True):
                trunk, tg, tb, g = tail_inputs(batch, dtype, dtype, dev)
                passes(f"tail bwd {str(dtype).split('.')[1]} batch {batch} taps {taps}",
                       lambda: rt._launch_bwd(g, trunk, tg, tb, need_taps=taps))  # noqa: B023
        for batch, channels in ((1, 64), (8, 64), (1, 128)):
            x, tr, tg, tb, g = head_inputs(batch, channels, dtype, dev)
            _, trunk = rh._launch(x, tr, tg, tb, SCALES)
            passes(f"head bwd {str(dtype).split('.')[1]} C {channels} batch {batch}",
                   lambda: rh._launch_bwd(g, x, trunk, tr, tg, tb, SCALES))  # noqa: B023
    print(f"device: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
