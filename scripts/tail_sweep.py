"""Sweep of the `rgb_beta_tail` kernel over the number of cell rows a block
computes, on one NVIDIA GPU (Hopper):

    python3 scripts/tail_sweep.py        # from the root of the repository

Builds `npe_tpu_torch/csrc/rgb_beta_tail.cu` (printing nvcc's register and
spill report), and at a 16x16 cell map, batch 1, 8, 16, 64 and 128, checks
the kernel against its plain version and times it by CUDA-graph replay at
every row count that divides the map's height (1 to 16; at 16 a block holds
the whole image, as the first version of the kernel did), beside the count
the wrapper picks (`ops.kernels.rgb_beta_tail.tail_rows`). It is the
evidence for that function's rule; chip_smoke.py holds the kernel's times on
the main path's shapes.
"""

import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
from npe_tpu_torch.ops.kernels import build  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt  # noqa: E402
from npe_tpu_torch.utils.timing import graph_ms  # noqa: E402

H = W = 16


def run_with(trunk, tg, tb, rows):
    """The kernel's C entry point with a row count of the caller's choice."""
    n = trunk.shape[0]
    out = torch.empty((n, 3 * rt.RR, H, W), device=trunk.device)
    rc = rt._entry()(trunk.data_ptr(), tg.data_ptr(), tb.data_ptr(), out.data_ptr(), n, H, W, rows,
                     torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def main():
    if not torch.cuda.is_available():
        print("tail_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain version's convs in float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    print("\n".join(line for line in build.build("rgb_beta_tail").splitlines() if "Used" in line or "spill" in line))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.no_grad():
        for batch in (1, 8, 16, 64, 128):
            rng = np.random.RandomState(batch)
            trunk = torch.from_numpy(rng.randn(batch, 6 * rt.RR, H, W).astype(np.float32)).to(dev)
            tg = torch.from_numpy((rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)).to(dev)
            tb = torch.from_numpy((rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)).to(dev)
            want = rt.rgb_beta_tail_reference(trunk, tg, tb)
            times = {}
            for rows in (1, 2, 4, 8, 16):
                err = float((run_with(trunk, tg, tb, rows) - want).abs().max())
                assert err <= 1e-5, (batch, rows, err)
                times[rows] = round(graph_ms(lambda: run_with(trunk, tg, tb, rows), iters=20, reps=10) * 1e3, 2)  # noqa: B023
            pick = rt.tail_rows(batch, H, W, sms)
            print(f"batch {batch}: us by rows a block {times}; wrapper ({pick} rows) "
                  f"{graph_ms(lambda: rt.rgb_beta_tail(trunk, tg, tb), iters=20, reps=10) * 1e3:.2f} us; "  # noqa: B023
                  f"plain {graph_ms(lambda: rt.rgb_beta_tail_reference(trunk, tg, tb), iters=20, reps=10) * 1e3:.2f} us",  # noqa: B023
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
