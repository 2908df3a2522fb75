"""Serving latency and throughput of npe_tpu_torch's micro-batching
InferenceServer on one NVIDIA GPU (the port's counterpart of
bench_serving.py).

For one model (and head / MDBLOCK form and wire) it measures:

  * single-request latency p50 / p95 of each op, on the client's clock:
    encode (image -> z) and decode (z -> image; the editor's hot op);
  * offered load: N concurrent 1-image encodes through the micro-batcher,
    in completed requests per second, and the mean group it formed;
  * the server's own per-op EMA of group time (wall time around the upload,
    the model and the download of one group; serving.py `_serve`);
  * the transport floor: p50 / p95 of one tiny host-to-device and
    device-to-host copy pair, what any request pays before the model runs;
  * for each path (`--path`: the captured server, the server's own path,
    and an eager twin, `InferenceServer(eager=True)`), the buckets whose
    programs were made, each one's first call (on the captured path the
    eager call and the capture) and the peak device memory the server added.

A host-bound p50 moves 1.3-2.5x between calls, so every figure is measured
`--repeats` times on one server and the median is reported beside each run's
value. Latency does not depend on the weights' values, so the server runs
seeded random weights. chip_smoke.py imports these functions, so the figures
it prints come from this code too.

Usage: python3 bench_torch_serving.py [--model IAN_simple] [--n 100] [--load 256]
           [--repeats 3] [--wire float32|uint8] [--head-mode M] [--mdblock-mode M]
           [--path captured,eager]
Prints one JSON line: the first path's figures at the top level, every
path's under "paths". Exits nonzero without a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

WAIT = 600  # seconds: the longest a request may take, the kernels' first build included
PATHS = ("captured", "eager")


def pctl(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def transport_floor_ms(device, n):
    """p50 and p95, ms, of one 4-byte host-to-device copy and one
    device-to-host copy, each pair waiting for the last (the value is chained
    through the host)."""
    host = 0.0
    for _ in range(5):  # warm
        host = float(torch.tensor([host]).to(device).cpu()[0])
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        host = float(torch.tensor([host + 1.0]).to(device).cpu()[0])
        ts.append((time.perf_counter() - t0) * 1e3)
    return pctl(ts, 50), pctl(ts, 95)


def single_request_ms(server, op, arr, n, warm=3):
    """p50 and p95, ms, of `n` sequential single requests: what one
    interactive client sees."""
    submit = getattr(server, op)
    for _ in range(warm):  # the kernels' first build, and the EMA's seed
        submit(arr).result(timeout=WAIT)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        submit(arr).result(timeout=WAIT)
        ts.append((time.perf_counter() - t0) * 1e3)
    return pctl(ts, 50), pctl(ts, 95)


def offered_load(server, arr, n_requests):
    """`n_requests` concurrent 1-image encodes, each from a client thread of
    its own that waits for its result: completed requests per second."""
    with ThreadPoolExecutor(max_workers=min(n_requests, 256)) as ex:
        t0 = time.perf_counter()
        futs = [ex.submit(lambda: server.encode(arr).result(timeout=WAIT)) for _ in range(n_requests)]
        for f in futs:
            f.result(timeout=WAIT)
        dt = time.perf_counter() - t0
    return n_requests / dt


def measure(server, n, load):
    """One run of every figure on `server`: a dict of numbers (ms, req/s)."""
    img = np.zeros((1, 64, 64, 3), np.float32)
    z = np.zeros((1, server.module.cfg["num_latents"]), np.float32)
    enc = single_request_ms(server, "encode", img, n)
    dec = single_request_ms(server, "decode", z, n)
    floor = transport_floor_ms(server.device, n)
    out = {"encode_p50_ms": enc[0], "encode_p95_ms": enc[1], "decode_p50_ms": dec[0], "decode_p95_ms": dec[1],
           "transport_floor_p50_ms": floor[0], "transport_floor_p95_ms": floor[1]}
    for op, ema in server._kernel_ema.items():
        out[f"{op}_ema_ms"] = None if ema is None else ema * 1e3
    if load:
        groups, items = server.stats["batches"], server.stats["batched_items"]
        out["load_req_per_s"] = offered_load(server, img, load)
        out["load_mean_group"] = (server.stats["batched_items"] - items) / max(1, server.stats["batches"] - groups)
    return out


def median_of(runs):
    """{figure: median over runs} (None where a run has no value)."""
    return {k: (None if any(r[k] is None for r in runs) else float(np.median([r[k] for r in runs])))
            for k in runs[0]}


def run_path(server, n, load, repeats):
    """`repeats` runs of `measure` on one server: their median, every run,
    the server's counters, the buckets of each op whose programs were made
    and each program's first call, ms."""
    runs = [measure(server, n, load) for _ in range(repeats)]
    buckets, first = {"encode": [], "decode": []}, {}
    for (op, specs), sig in server.programs.signatures.items():
        buckets[op].append(specs[0][0][0])
        first[f"{op} {specs[0][0][0]}"] = sig.first_call_ms
    return {"median": median_of(runs), "runs": runs, "stats": dict(server.stats),
            "buckets": {op: sorted(b) for op, b in buckets.items()}, "first_call_ms": first,
            "captures": sum(server.programs.captures().values())}


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="IAN_simple")
    p.add_argument("--n", type=int, default=100, help="sequential requests per op and run")
    p.add_argument("--load", type=int, default=256, help="concurrent requests of the throughput leg (0 = skip)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--wire", default="float32", choices=["float32", "uint8"])
    p.add_argument("--head-mode", default=None)
    p.add_argument("--mdblock-mode", default=None)
    p.add_argument("--path", default=",".join(PATHS),
                   help="comma-separated: captured (the server's path), eager; the first gives the headline")
    a = p.parse_args(argv)
    a.paths = a.path.split(",")
    if sorted(set(a.paths) - set(PATHS)) or len(set(a.paths)) != len(a.paths):
        p.error(f"--path takes {PATHS}, each once, got {a.path!r}")
    return a


def main(argv=None):
    a = parse(argv)
    if not torch.cuda.is_available():
        print("bench_torch_serving: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from npe_tpu_torch.serving import InferenceServer

    variables = None
    paths = {}
    for path in a.paths:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        server = InferenceServer(config=a.model, variables=variables, max_batch=a.max_batch, wire=a.wire,
                                 head_mode=a.head_mode, mdblock_mode=a.mdblock_mode, eager=path == "eager")
        variables = server.variables  # every path serves the same seeded weights
        try:
            paths[path] = run_path(server, a.n, a.load, a.repeats)
        finally:
            server.close()
        torch.cuda.synchronize()
        paths[path]["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        print(f"{a.model} {path}: decode p50 {paths[path]['median']['decode_p50_ms']:.3f} ms", file=sys.stderr)
    print(json.dumps({"model": a.model, "wire": a.wire, "head_mode": a.head_mode, "mdblock_mode": a.mdblock_mode,
                      "max_batch": a.max_batch, "n": a.n, "load_requests": a.load, "repeats": a.repeats,
                      "path": a.paths[0], **paths[a.paths[0]], "paths": paths,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
