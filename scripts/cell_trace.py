"""One run of a benchmark cell on the card, as `benchmark/run.py` makes it,
printed with what a traced result line leaves out: the device's idle time
summed over every gap by what the host was doing across it, named as the
result's `breakdown` names its longest gaps (`Trace.open_at`), and each
`npe.*` span's count and time inside the window.

    python3 scripts/cell_trace.py --workload edit-IAN-fused-fp32 --seed 2147487301 --trace 1
    python3 scripts/cell_trace.py --workload train-IANv1-fp32 --seed 246567982 --deterministic

`--deterministic` runs under `torch.use_deterministic_algorithms(True,
warn_only=True)` and `cudnn.deterministic`, so that two commits' checks of
one seed can be held equal bit for bit (cuDNN's default algorithms are not
deterministic). Prints one line, `CELL_TRACE {...}`: the result line's
`correct`, `attempted`, `metrics`, `checks` and `device`, and traced
`idle_ms_by_open_at` and `spans`.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def idle_by_open_at(trace):
    """{what the host was doing across a gap: ms of the device's idle time}."""
    out = {}
    for s, e in trace.gaps():
        name = trace.open_at((s + e) / 2)
        out[name] = out.get(name, 0.0) + (e - s) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_times(trace):
    """{npe.* span: (count, ms inside the window, longest ms)}."""
    times = {}
    for name, s, e in trace.host:
        if name.startswith("npe.") and e > trace.lo and s < trace.hi:
            times.setdefault(name, []).append((min(e, trace.hi) - max(s, trace.lo)) / 1e3)
    return {k: (len(v), sum(v), max(v)) for k, v in times.items()}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--deterministic", action="store_true")
    a = p.parse_args()
    if a.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, str(ROOT))
    from benchmark.run import CACHE

    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    import torch

    from benchmark import core

    if a.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
    run = core.Run(a.workload, a.seed, a.seconds, a.trace, "cuda")
    res = core.execute(run, STARTED)
    out = {"workload": a.workload, "seed": a.seed, "deterministic": a.deterministic,
           **{k: res[k] for k in ("correct", "attempted", "device")},
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "checks": {k: v["value"] for k, v in res["checks"].items()}}
    if run.profile is not None:
        out["idle_ms_by_open_at"] = idle_by_open_at(run.profile)
        out["spans"] = span_times(run.profile)
    print("CELL_TRACE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
