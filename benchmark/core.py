"""The benchmark's run of one cell: find the cell's configuration, traffic
mix, limits, generator and per-layer readers by the names in BENCHMARK.json,
set up, measure one window, check what the window produced against the
plain reference, and build the result line.

Everything a cell needs is found by name, so a later change adds a cell, a
configuration, a traffic mix or a per-layer metric as new files and entries:
  configs/<file named by the configuration's entry>
  traffic/<traffic>.json        parameters, and "kind", which names
  generators/<kind>.py          the general generator of that kind, which drives the program
  limits/<workload>.json        the limit of each number its check compares
  metrics/<metric>.py or metrics/<metric's name up to its first dot>.py
A generator module defines setup(run), window(run, seconds), release(run),
readings(run, subject), end_to_end(run) and unit_flops(run); end_to_end
returns its values by metric name, and a cell's metric "<name>.<part>"
(one quantity, split by cell) takes the value of "<name>"; a reader
module defines read(run), which returns a number or None when the window
gave it nothing to read.
"""

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "npe_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def spec():
    return load_json(ROOT / "BENCHMARK.json")


def module_by_file(folder, name):
    """The module benchmark.<folder>.<name>, imported from its file (a name
    may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        return None
    key = f"benchmark.{folder}.{name.replace('.', '__')}"
    if key not in sys.modules:
        loader = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(loader)
        sys.modules[key] = mod
        loader.loader.exec_module(mod)
    return sys.modules[key]


def generator(kind):
    mod = module_by_file("generators", kind)
    if mod is None:
        raise KeyError(f"no generator benchmark/generators/{kind}.py")
    return mod


def reader(metric):
    mod = module_by_file("metrics", metric) or module_by_file("metrics", metric.split(".", 1)[0])
    if mod is None:
        raise KeyError(f"no reader benchmark/metrics/{metric}.py or {metric.split('.', 1)[0]}.py")
    return mod


def forbidden_modules(names=None):
    """Of `names` (the loaded modules by default), the top-level names that
    are JAX's, its libraries' or the JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


class Run:
    """One run of one cell: what the harness and the generator share. The
    generator keeps its state in attributes of its own; `work` counts the
    units (strokes, batches, steps) the window completed and `window_s` its
    length on the host's clock."""

    def __init__(self, workload, seed, seconds, trace, device, bench=None):
        bench = bench or spec()
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
        self.workload = cells[workload]
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(ROOT / entry["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{workload}.json")
        self.bench = bench
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        self.work, self.window_s, self.profile, self.counts = 0, None, None, {}

    def span(self, name):
        """A host span in the traced window, nothing otherwise."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("bench." + name)

    def end_to_end_names(self):
        return [m["name"] for m in self.bench["end_to_end"]
                if "workloads" not in m or self.workload["name"] in m["workloads"]]

    def per_layer_names(self):
        e2e = set(self.end_to_end_names())
        return [m["name"] for m in self.bench["per_layer"]
                if m["moves"] in e2e and ("workloads" not in m or self.workload["name"] in m["workloads"])]


def counters():
    """The program's launch counters, by wrapper and form."""
    from npe_tpu_torch.utils import graphs

    return {f"{fn.__name__}.{attr}": n for (fn, attr), n in zip(graphs.COUNTERS, graphs.read_counts())}


def execute(run, started):
    """Set up, measure, check; returns the result object. `started` is the
    host time (time.perf_counter) at which the process began."""
    import torch

    gen = generator(run.traffic["kind"])
    torch.backends.cuda.matmul.allow_tf32 = bool(run.config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(run.config.get("tf32", False))
    cuda = torch.device(run.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gen.setup(run)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    before = counters()
    if run.trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function("bench.window"):
                gen.window(run, min(run.seconds, float(run.traffic["trace_seconds"])))
                if cuda:
                    torch.cuda.synchronize()
        from benchmark.yardstick.trace import from_profile

        run.profile = from_profile(prof)
        del prof
    else:
        gen.window(run, run.seconds)
        if cuda:
            torch.cuda.synchronize()
    after = counters()
    run.counts = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if run.trace:
        metrics = {}
        for name in run.per_layer_names():
            value = reader(name).read(run)
            if value is not None:
                unit = next(m["unit"] for m in run.bench["per_layer"] if m["name"] == name)
                metrics[name] = {"value": value, "unit": unit}
    else:
        e2e = gen.end_to_end(run)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in run.bench["end_to_end"]}
        # a cell's metric "<name>.<part>" is its generator's "<name>", as a reader's file is found
        metrics = {name: {"value": e2e[name] if name in e2e else e2e[name.split(".", 1)[0]], "unit": units[name]}
                   for name in run.end_to_end_names()}
    gen.release(run)
    if cuda:
        torch.cuda.empty_cache()
    readings = gen.readings(run, "program")
    checks = {k: {"value": readings[k], "limit": run.limits[k]} for k in run.limits}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(run.work), "failed": 0, "metrics": metrics,
              "device": device_info(run, peak)}
    if run.trace:
        result["device"]["busy_s"] = run.profile.busy_s()
        result["device"]["window_s"] = run.profile.window_s
        result["breakdown"] = run.profile.breakdown()
    result["checks"] = checks
    return result


def device_info(run, peak):
    import torch

    if torch.device(run.device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(run.workload["chips"]),
            "memory_peak_bytes": int(peak)}
