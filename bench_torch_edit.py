"""Edit-step latency of npe_tpu_torch on one NVIDIA GPU (the port's
counterpart of bench_edit.py).

One edit step is `EditSession.paint_stroke`: the gradient of the patch loss
with respect to z through the decoder, the latent step, the decode and the
mask/composite tail (`NPE.py:192-235`). For each model and form -- IAN_simple;
IANv1 with the head in the hybrid and the fused form; full IAN with its
MDBLOCKs in the per-op and the fused form -- each dtype, and each path --
`captured`, the session's path on the card (one CUDA graph a stroke,
`editor/captured.py`), and `eager` (the same bodies without graphs,
`EditSession(eager=True)`) -- it reports:

  * stroke latency p50 / p95, ms, on the host's clock, each stroke ending in
    the device-to-host copy of the shown image (what the person at the brush
    waits for), over `--strokes` strokes of a varied 16-stroke script (boxes
    of 4 to 20 pixels, hard and feathered brushes);
  * device ms per step: the device kernels' time of a stroke under
    torch.profiler over 20 strokes, the device's idle share, and the host's
    launches a stroke (the CUDA runtime calls that enqueue work: kernel and
    graph launches, copies, memsets).

A host-bound p50 moves 1.3-2.5x between runs, so the latencies are measured
`--repeats` times and the median is reported, with every run and the spread.
Each result carries every path under "paths"; its top-level figures are the
first path's (the captured one by default). Weights are seeded random draws
(latency does not depend on their values). chip_smoke.py imports
`stroke_script`, `stroke_times` and `device_ms_per_stroke`.

Usage: python3 bench_torch_edit.py [--dtypes float32,bfloat16] [--strokes 100] [--repeats 3]
           [--models IAN_simple,IANv1,IAN] [--path captured,eager]
Prints one JSON line. Exits nonzero without a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_MS = 10.0  # p50 limit of a stroke (PERF.md section 2)
N_STROKES = 16
DTYPES = ("float32", "bfloat16")
PATHS = ("captured", "eager")
# the CUDA API calls (runtime `cuda*` and low-level `cu*`) that enqueue work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")
FORMS = (("IAN_simple", {}), ("IANv1", {"head_mode": "hybrid"}), ("IANv1", {"head_mode": "fused"}),
         ("IAN", {"mdblock_mode": "plain"}), ("IAN", {"mdblock_mode": "fused"}))


def stroke_script():
    """16 strokes with varied boxes, colours and sigma in {0, 0.5}."""
    rng = np.random.RandomState(7)
    strokes = []
    for i in range(N_STROKES):
        w, h = rng.randint(4, 21, 2)
        x1, y1 = rng.randint(0, 64 - w), rng.randint(0, 64 - h)
        rgb = tuple(int(c) for c in rng.randint(0, 256, 3))
        strokes.append((int(x1), int(y1), int(x1 + w), int(y1 + h), rgb, 0.5 * (i % 2)))
    return strokes


def stroke_times(session, image, n, warm=10):
    """ms of each of `n` strokes on the host's clock after `warm` strokes,
    from a fresh infer of `image`."""
    session.infer(image)
    strokes = stroke_script()
    for i in range(warm):
        session.paint_stroke(*strokes[i % N_STROKES])
    times = []
    for i in range(n):
        t = time.perf_counter()
        session.paint_stroke(*strokes[i % N_STROKES])
        times.append((time.perf_counter() - t) * 1e3)
    return times


def device_ms_per_stroke(session, n=20):
    """(device kernel ms per stroke, the device's idle share, the profiler's
    kernel averages, host launches per stroke) over `n` strokes under
    torch.profiler; (None, None, [], None) if it recorded no device time."""
    from torch.autograd import DeviceType

    strokes = stroke_script()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(n):
            session.paint_stroke(*strokes[i % N_STROKES])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        return None, None, [], None
    launches = sum(e.count for e in events if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS)
    return busy / n, 1 - busy / wall, kernels, launches / n


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtypes", default=",".join(DTYPES), help="comma-separated: float32, bfloat16")
    p.add_argument("--strokes", type=int, default=100, help="timed strokes a run")
    p.add_argument("--repeats", type=int, default=3, help="runs; the median is reported")
    p.add_argument("--models", default="IAN_simple,IANv1,IAN", help="comma-separated; each in all its forms")
    p.add_argument("--path", default=",".join(PATHS),
                   help="comma-separated: captured (the session's path), eager; the first gives the headline")
    a = p.parse_args(argv)
    models, dtypes, paths = a.models.split(","), a.dtypes.split(","), a.path.split(",")
    unknown = (sorted(set(models) - {m for m, _ in FORMS}) + sorted(set(dtypes) - set(DTYPES))
               + sorted(set(paths) - set(PATHS)))
    if unknown or a.strokes < 1 or a.repeats < 1 or len(set(paths)) != len(paths):
        p.error(f"unknown models, dtypes or paths {unknown}" if unknown
                else "--strokes and --repeats must be positive, and each path named once")
    a.forms = [(m, o) for m, o in FORMS if m in models]
    a.dtypes, a.paths = dtypes, paths
    return a


def time_path(session, image, strokes, repeats):
    """One path's figures: p50 / p95 (the median of `repeats` runs), every
    run's, the spread, device ms a stroke, idle share, host launches a
    stroke."""
    runs = [np.percentile(stroke_times(session, image, strokes), [50, 95]) for _ in range(repeats)]
    p50s = [float(r[0]) for r in runs]
    device_ms, idle, _, launches = device_ms_per_stroke(session)
    p50 = float(np.median(p50s))
    return {"p50_ms": p50, "p95_ms": float(np.median([r[1] for r in runs])), "runs_p50_ms": p50s,
            "runs_p95_ms": [float(r[1]) for r in runs], "spread_frac": (max(p50s) - min(p50s)) / p50,
            "vs_baseline": BASELINE_MS / p50, "device_ms_per_stroke": device_ms, "idle_share": idle,
            "host_launches_per_stroke": launches}


def main(argv=None):
    a = parse(argv)
    if not torch.cuda.is_available():
        print("bench_torch_edit: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from npe_tpu_torch.editor.engine import EditSession
    from npe_tpu_torch.models import get_config

    image = ((np.random.RandomState(3).rand(3, 64, 64) * 2 - 1) * 0.8).astype(np.float32)
    results = []
    for model in dict.fromkeys(m for m, _ in a.forms):
        variables = get_config(model).init(torch.Generator().manual_seed(0), "cuda")
        for _, options in (f for f in a.forms if f[0] == model):
            for dtype in a.dtypes:
                paths = {}
                for path in a.paths:
                    session = EditSession(model, variables=variables, device="cuda", dtype=dtype,
                                          eager=path == "eager", **options)
                    paths[path] = time_path(session, image, a.strokes, a.repeats)
                    if path == "captured":
                        paths[path]["captures"] = {k: p.captures for k, p in session.runner.programs.items()}
                    print(f"{model} {options} {dtype} {path}: p50 {paths[path]['p50_ms']:.3f} ms, device "
                          f"{paths[path]['device_ms_per_stroke']} ms", file=sys.stderr)
                    del session
                results.append({"model": model, "form": options, "dtype": dtype, "path": a.paths[0],
                                **paths[a.paths[0]], "paths": paths})
        del variables
    print(json.dumps({"metric": "paint_stroke_latency", "unit": "ms", "strokes": a.strokes, "repeats": a.repeats,
                      "paths": a.paths, "results": results, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
