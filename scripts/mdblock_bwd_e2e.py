"""The fused full-IAN edit stroke and the captured `imgrad` of two checkouts
of the repository, in turns, on one NVIDIA GPU (Hopper), from the root of
the repository:

    mkdir -p scratch_archive/parent17 && git archive 1f72098 | tar -x -C scratch_archive/parent17
    python3 scripts/mdblock_bwd_e2e.py scratch_archive/parent17

Each side runs in a process of its own from its checkout's root, so the
other side's package and kernels never load: other, current, current,
other. A side times full IAN with `mdblock_mode="fused"` (seeded weights,
bench_torch_edit.py's draw), float32 and bf16, TF32 off:

  * the captured stroke: p50 over `STROKES` strokes of bench_torch_edit.py's
    16-stroke script (host clock, each ending in the image's download; that
    checkout's `stroke_times`), and its device ms;
  * `api.IAN.imgrad` at batch 1, captured: p50 over `CALLS` calls (host
    clock, each ending in its download), and its device ms.

Device ms is torch.profiler's, over 20 strokes or calls, two ways: the sum
of the kernels' durations (bench_torch_edit.py's reading), and the union of
their intervals. The two part where kernels overlap: a launch made with
programmatic dependent launch starts before the one it follows ends, and its
duration counts its wait.

One line a side and case, and a JSON summary in runs/mdblock_bwd_e2e.json.
"""

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

STROKES, CALLS, DTYPES = 100, 50, ("float32", "bfloat16")


def device_ms(fn, n=20):
    """(sum of the kernels' durations, union of their intervals) in ms a
    fn() call, torch.profiler over n calls after one."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    return sum(b - a for a, b in spans) / n / 1e3, union / n / 1e3


def side():
    """This checkout's figures, as JSON on the last line."""
    sys.path.insert(0, os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench_torch_edit import stroke_script, stroke_times
    from npe_tpu_torch.api import IAN
    from npe_tpu_torch.editor.engine import EditSession
    from npe_tpu_torch.models import get_config

    image = ((np.random.RandomState(3).rand(3, 64, 64) * 2 - 1) * 0.8).astype(np.float32)
    variables = get_config("IAN").init(torch.Generator().manual_seed(0), "cuda")
    out = {}
    for dtype in DTYPES:
        session = EditSession("IAN", variables=variables, device="cuda", dtype=dtype, mdblock_mode="fused")
        p50 = float(np.percentile(stroke_times(session, image, STROKES), 50))
        strokes, i = stroke_script(), itertools.count()
        stroke_sum, stroke_union = device_ms(lambda: session.paint_stroke(*strokes[next(i) % len(strokes)]))  # noqa: B023
        del session
        ian = IAN("IAN", variables=variables, device="cuda", dtype=dtype, mdblock_mode="fused")
        z = np.random.RandomState(31).randn(1, ian.get_zdim()).astype(np.float32)
        call = lambda: ian.imgrad(8, 8, 24, 24, z)  # noqa: E731, B023
        call()
        times = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        imgrad_sum, imgrad_union = device_ms(call)
        out[dtype] = {"stroke_p50_ms": p50, "stroke_device_ms": stroke_sum, "stroke_device_union_ms": stroke_union,
                      "imgrad_p50_ms": float(np.median(times)), "imgrad_device_ms": imgrad_sum,
                      "imgrad_device_union_ms": imgrad_union}
        del ian
    return out


def main():
    if len(sys.argv) == 2 and sys.argv[1] == "--side":
        print(json.dumps(side()))
        return 0
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("mdblock_bwd_e2e: needs an NVIDIA GPU and the other checkout's directory", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    roots = {"other": os.path.abspath(sys.argv[1]), "current": os.getcwd()}
    runs = []
    for name in ("other", "current", "current", "other"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--side"], cwd=roots[name],
                           stdout=subprocess.PIPE, text=True)
        if r.returncode != 0:
            print(f"mdblock_bwd_e2e: the {name} side failed ({r.returncode})", file=sys.stderr)
            return 1
        runs.append((name, json.loads(r.stdout.strip().splitlines()[-1])))
        for dtype, fig in runs[-1][1].items():
            print(f"[e2e] {name} full IAN fused {dtype}: stroke p50 {fig['stroke_p50_ms']:.4f} ms, device "
                  f"{fig['stroke_device_ms']:.4f} ms a stroke (union {fig['stroke_device_union_ms']:.4f}); imgrad "
                  f"p50 {fig['imgrad_p50_ms']:.4f} ms, device {fig['imgrad_device_ms']:.4f} ms (union "
                  f"{fig['imgrad_device_union_ms']:.4f}) ({smi})", flush=True)
    os.makedirs("runs", exist_ok=True)
    with open("runs/mdblock_bwd_e2e.json", "w") as fh:
        json.dump({"device": smi, "turns": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
