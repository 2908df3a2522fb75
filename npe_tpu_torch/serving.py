"""Batched inference serving (npe_tpu `serving.py`).

A thread-safe micro-batching server: concurrent encode / decode requests are
gathered into batches of at most `max_batch`, run on the device, and the
results fanned back out to the callers' futures.

Design: requests enqueue (op, array, Future, deadline, slo_deadline); one
dispatcher thread drains the queue, groups requests of one op, runs the
group (split at `max_batch`) and resolves the futures.

Programs: as npe_tpu runs each op as one jitted program of a fixed shape,
each op runs as one program per batch size (`utils/graphs.ProgramCache`): on
the card a CUDA graph of the upload's consumer, the model and the output's
layout, captured by the dispatcher thread at the first group of that size
and replayed by every later one. npe_tpu pads every group to `max_batch`;
here a group (each part of a split) is padded with zero rows to its bucket,
the smallest power of two that holds it, at most `max_batch`, so an op
captures at most ceil(log2(max_batch)) + 1 graphs, and a lone request does
not pay for `max_batch` images. Rows are independent at inference; the pad
rows are dropped before the futures resolve. `eager=True` runs the same
bodies without graphs on the card; the CPU never has graphs.

Robustness, as in npe_tpu:
  * strict FIFO across ops: a request of the other op parks at the front of
    a pending deque and leads the NEXT group, never behind newer arrivals;
  * per-request timeouts (a request not dispatched by its deadline fails
    with TimeoutError instead of taking batch slots) and
    concurrent.futures cancellation;
  * a failing group delivers its exception to each of its futures; the
    dispatcher survives;
  * a transport: `serve_http` / `python -m npe_tpu_torch.serving` serve
    /encode /decode /healthz /stats /models over JSON HTTP (one in-process
    server shared by all connections, so requests batch across them).

Latency SLOs: a request may carry `slo` seconds. The dispatcher keeps an EMA
of each op's group time and stops aggregating when now + that estimate would
breach the tightest member's SLO. Only warm groups feed it: a group whose
parts all ran a program made before (npe_tpu waits for a warm call too); a
group that captured, however fast, does not.

Multi-model hosting: `ModelHost` runs several named InferenceServers in one
process, one dispatcher thread each, on one device; HTTP routes
/<model>/encode|decode, default-model /encode|/decode and GET /models.

Public contract (npe_tpu's, so its HTTP clients carry over): `encode` takes
(n, 64, 64, 3) NHWC images in [-1, 1] and `decode` returns NHWC. The port's
models run NCHW: the programs transpose on the device after the upload and
before the download.

Wire format: with `wire="uint8"` images cross the host<->device link as
uint8 (a quarter of the float32 bytes). Encode inputs are quantised to the
[0, 255] grid on the caller's thread, uploaded as uint8 and brought to
[-1, 1] on the device by the `staging` kernel, inside the encode's program
(`ops/kernels/staging.stage_uint8_to_tanh`; its plain version on the CPU).
Decode outputs are quantised to uint8 on the device and brought back to
[-1, 1] on the host. Lossless for inputs that came from uint8 images, else
at most one 1/255-of-range step per direction. The default is "float32".

Every model call of the dispatcher runs under `torch.inference_mode()`: grad
mode is thread-local, so a caller's `no_grad` never reaches that thread.

bfloat16 (`dtype=torch.bfloat16`, `--bf16`): the model runs in bf16, as
npe_tpu serves it: the weights are cast once, inputs are cast on the device at
the model's boundary (under wire="uint8" after the `staging` kernel, whose
output is float32), and outputs are widened to float32 there, so both wires
carry what they carry in float32.
"""

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from npe_tpu_torch.api import decode_options
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels.staging import stage_uint8_to_tanh
from npe_tpu_torch.utils import checkpoints
from npe_tpu_torch.utils.cast import cast_floating, resolve_dtype
from npe_tpu_torch.utils.device import resolve_device
from npe_tpu_torch.utils.graphs import ProgramCache
from npe_tpu_torch.utils.ranges import from_tanh, to_tanh

WIRES = ("float32", "uint8")


class InferenceServer:
    def __init__(
        self,
        config="IAN_simple",
        variables=None,
        weights_path=None,
        max_batch=64,
        linger_ms=2.0,
        dtype=None,
        seed=0,
        wire="float32",
        device="cuda",
        head_mode=None,
        mdblock_mode=None,
        eager=False,
    ):
        """variables: port variables on `device`; drawn from
        torch.Generator(seed) when None. head_mode / mdblock_mode: the forms
        every decode takes, as `api.IAN` passes them (None leaves the
        model's default). dtype: torch.bfloat16 (or "bfloat16") serves in
        bf16, the weights drawn or loaded in float32 and cast once; None or
        float32 serves in float32; any other dtype raises ValueError. eager:
        on the card, run the ops' bodies without CUDA graphs (for
        comparisons and timings)."""
        self.dtype = resolve_dtype(dtype)
        if wire not in WIRES:
            raise ValueError(f"wire must be 'float32' or 'uint8', got {wire!r}")
        self.device = resolve_device(device)
        self.module = get_config(config)
        self.decode_options = decode_options(head_mode, mdblock_mode)
        if variables is None:
            variables = self.module.init(torch.Generator().manual_seed(seed), self.device)
        if weights_path is not None:
            checkpoints.load_weights(weights_path, variables)
        if dtype is not None:
            variables = cast_floating(variables, self.dtype)
        self.variables = variables
        self.max_batch = max_batch
        self.linger = linger_ms / 1000.0
        self.wire = wire
        self.programs = ProgramCache(self.device, eager)
        self.programs.define("encode", self._encode_body)
        self.programs.define("decode", self._decode_body)
        self._kernels = {"encode": self._encode, "decode": self._decode}
        # per-op EMA of group wall time; None until a warm group of the op
        # (the first group of a size runs eagerly and captures)
        self._kernel_ema = {"encode": None, "decode": None}
        self._q = queue.Queue()
        self._pending = deque()  # parked items, strictly older than the queue
        self._stop = threading.Event()
        self._requests_lock = threading.Lock()  # callers' threads count requests
        self.stats = {
            "requests": 0,
            "batches": 0,
            "batched_items": 0,
            "timeouts": 0,
            "errors": 0,
            "slo_tightened": 0,
        }
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # --- public API ----------------------------------------------------------

    def encode(self, images_nhwc, timeout=None, slo=None):
        """(n, 64, 64, 3) [-1, 1] -> Future of (n, zdim). `timeout` (seconds)
        bounds QUEUE time: a request not dispatched by then fails with
        TimeoutError. `slo` (seconds) is a total-latency target: the batcher
        stops aggregating early rather than linger past it.

        Under wire='uint8' a uint8 [0, 255] array is taken as it is; float
        input is quantised to that grid HERE, on the caller's thread."""
        arr = np.asarray(images_nhwc)
        if self.wire == "uint8":
            if arr.dtype != np.uint8:
                arr = np.clip(np.round(from_tanh(np.float32(arr))), 0.0, 255.0).astype(np.uint8)
        else:
            arr = np.asarray(arr, np.float32)
        return self._submit("encode", arr, timeout, slo)

    def decode(self, z, timeout=None, slo=None):
        """(n, zdim) -> Future of (n, 64, 64, 3)."""
        return self._submit("decode", np.asarray(z, np.float32), timeout, slo)

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=5)

    # --- the device work of one group ----------------------------------------

    def bucket(self, n):
        """The batch a group part of n rows runs at: the smallest power of
        two that holds it, at most max_batch."""
        return min(self.max_batch, 1 << (n - 1).bit_length())

    def _encode_body(self, x_nhwc):
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        if self.wire == "uint8":
            x = stage_uint8_to_tanh(x)  # uint8 bytes uploaded; the range changes on the device
        return self.module.encode(self.variables, x.to(self.dtype)).float()

    def _decode_body(self, z):
        y = self.module.decode(self.variables, z.to(self.dtype), **self.decode_options).float().permute(0, 2, 3, 1)
        if self.wire == "uint8":
            y = torch.clamp(torch.round(from_tanh(y)), 0.0, 255.0).to(torch.uint8)
        return y.contiguous()

    def _encode(self, x_nhwc):
        return self.programs("encode", x_nhwc, pad_to=self.bucket(len(x_nhwc)))

    def _decode(self, z):
        y = self.programs("decode", z, pad_to=self.bucket(len(z)))
        return to_tanh(np.float32(y)) if self.wire == "uint8" else y

    # --- internals -----------------------------------------------------------

    def _submit(self, op, arr, timeout=None, slo=None):
        fut = Future()
        now = time.perf_counter()
        deadline = now + timeout if timeout is not None else None
        slo_deadline = now + slo if slo is not None else None
        with self._requests_lock:
            self.stats["requests"] += 1
        self._q.put((op, arr, fut, deadline, slo_deadline))
        return fut

    @staticmethod
    def _fail(fut, exc):
        try:
            fut.set_exception(exc)
        except Exception:
            pass  # lost a race with a caller-side cancel; nothing to deliver

    def _next_item(self, timeout=None):
        """Oldest live item: parked requests first, then the queue. Expired
        or cancelled requests are consumed (failing their futures) so they
        never take batch slots. Returns None on stop/timeout."""
        while True:
            if self._pending:
                item = self._pending.popleft()
            else:
                try:
                    item = self._q.get(timeout=timeout) if timeout is not None else self._q.get()
                except queue.Empty:
                    return None
            if item is None:
                self._q.put(None)
                return None
            op, arr, fut, deadline, _slo = item
            if fut.cancelled():
                continue
            if deadline is not None and time.perf_counter() > deadline:
                self.stats["timeouts"] += 1
                self._fail(fut, TimeoutError(f"{op} request expired before dispatch"))
                continue
            return item

    def _slo_cap(self, items):
        """Latest moment aggregation may continue without breaching any
        member's SLO: min(slo_deadline) - estimated group time. None when no
        member carries an SLO."""
        slos = [it[4] for it in items if it[4] is not None]
        if not slos:
            return None
        est = self._kernel_ema.get(items[0][0])
        return min(slos) - (est if est is not None else 0.0)

    def _drain(self, first):
        """Collect same-op requests up to max_batch within the linger window,
        shortened to respect the tightest member SLO. A different-op arrival
        parks at the FRONT of the pending deque, so it leads the next group."""
        items = [first]
        total = first[1].shape[0]
        deadline = time.perf_counter() + self.linger
        tightened = False
        while total < self.max_batch:
            cap = self._slo_cap(items)
            window_end = deadline
            if cap is not None and cap < window_end:
                window_end = cap
                tightened = True
            timeout = window_end - time.perf_counter()
            if timeout <= 0:
                break
            nxt = self._next_item(timeout=timeout)
            if nxt is None:
                break
            if nxt[0] != first[0]:
                self._pending.appendleft(nxt)
                break
            items.append(nxt)
            total += nxt[1].shape[0]
        if tightened:
            self.stats["slo_tightened"] += 1
        return items

    def _loop(self):
        with torch.inference_mode():
            self._serve()
        # shutdown: fail anything still queued rather than hanging callers
        while True:
            if self._pending:
                leftover = self._pending.popleft()
            else:
                try:
                    leftover = self._q.get_nowait()
                except queue.Empty:
                    break
            if leftover is not None:
                self._fail(leftover[2], RuntimeError("server closed"))

    def _serve(self):
        while not self._stop.is_set():
            item = self._next_item()
            if item is None:
                break
            items = self._drain(item)
            # the single running-state transition: last cancellation point
            items = [it for it in items if it[2].set_running_or_notify_cancel()]
            if not items:
                continue
            op = items[0][0]
            self.stats["batches"] += 1
            self.stats["batched_items"] += len(items)
            try:
                # inside the try: requests of unlike shapes fail their group,
                # not the dispatcher
                batch = np.concatenate([arr for _, arr, _, _, _ in items])
                cold = self.programs.first_calls
                t0 = time.perf_counter()
                parts = [
                    self._kernels[op](batch[s : s + self.max_batch])
                    for s in range(0, batch.shape[0], self.max_batch)
                ]
                result = np.concatenate(parts)
                dt = (time.perf_counter() - t0) / max(1, len(parts))
                if self.programs.first_calls == cold:
                    # a warm group: every part replayed a program made before
                    ema = self._kernel_ema.get(op)
                    self._kernel_ema[op] = dt if ema is None else 0.7 * ema + 0.3 * dt
            except Exception as e:  # a failing group: deliver to its futures
                self.stats["errors"] += len(items)
                for _, _, fut, _, _ in items:
                    self._fail(fut, e)
                continue
            off = 0
            for _, arr, fut, _, _ in items:
                k = arr.shape[0]
                fut.set_result(result[off : off + k])
                off += k


# --- multi-model hosting ------------------------------------------------------


class ModelHost:
    """Several named InferenceServers in one process, one device. Each model
    keeps its own dispatcher (per-model FIFO + batching); their kernels
    interleave on the shared card. The first added model is the default
    (unprefixed /encode and /decode routes)."""

    def __init__(self):
        self.servers = {}
        self.default = None

    def add(self, name, server):
        if name in self.servers:
            raise KeyError(f"model {name!r} already hosted")
        self.servers[name] = server
        if self.default is None:
            self.default = name
        return server

    def get(self, name=None):
        key = name or self.default
        if key not in self.servers:
            raise KeyError(f"unknown model {key!r}; have {sorted(self.servers)}")
        return self.servers[key]

    def stats(self):
        return {name: dict(s.stats) for name, s in self.servers.items()}

    def close(self):
        for s in self.servers.values():
            s.close()


# --- HTTP transport ----------------------------------------------------------


def serve_http(server, port=8900, host="127.0.0.1"):
    """JSON-over-HTTP transport for an InferenceServer or a ModelHost.

    POST /encode and /decode (default model) or /<model>/encode|decode take
    {"data": <nested list>, "timeout": <sec>, "slo_ms": <float>} and return
    {"result": <nested list>}; GET /healthz -> {"ok": true}, GET /stats ->
    the counters, GET /models -> hosted model names. Unknown paths, ops and
    models give 404, a request that timed out 504, any other failure 400.
    Returns the ThreadingHTTPServer (serve_forever on the caller's
    schedule)."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    host_obj = server if isinstance(server, ModelHost) else None

    def resolve(model_name):
        if host_obj is not None:
            return host_obj.get(model_name)
        if model_name is not None:
            raise KeyError(f"single-model server has no model {model_name!r}")
        return server

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {"ok": True})
            if self.path == "/stats":
                stats = host_obj.stats() if host_obj is not None else dict(server.stats)
                return self._reply(200, stats)
            if self.path == "/models":
                if host_obj is not None:
                    return self._reply(
                        200, {"models": sorted(host_obj.servers), "default": host_obj.default}
                    )
                return self._reply(200, {"models": ["default"], "default": "default"})
            return self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            parts = [p for p in self.path.split("/") if p]
            if len(parts) == 1:
                model_name, op = None, parts[0]
            elif len(parts) == 2:
                model_name, op = parts
            else:
                return self._reply(404, {"error": "unknown path"})
            if op not in ("encode", "decode"):
                return self._reply(404, {"error": "unknown op"})
            try:
                target = resolve(model_name)
            except KeyError as e:
                return self._reply(404, {"error": str(e)})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                arr = np.asarray(req["data"], np.float32)
                slo = req.get("slo_ms")
                fut = getattr(target, op)(
                    arr,
                    timeout=req.get("timeout"),
                    slo=slo / 1000.0 if slo is not None else None,
                )
                # block this connection thread; batching happens server-side
                result = fut.result(timeout=req.get("timeout", 600))
                return self._reply(200, {"result": result.tolist()})
            except TimeoutError as e:
                return self._reply(504, {"error": str(e) or "timeout"})
            except Exception as e:
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="npe_tpu_torch micro-batching inference server")
    p.add_argument("--config", default="IAN_simple")
    p.add_argument("--weights", default=None)
    p.add_argument(
        "--model",
        action="append",
        default=None,
        metavar="NAME=CONFIG[:WEIGHTS]",
        help="host an additional named model (repeatable); the first --model "
        "becomes the default route. Without --model, --config/--weights "
        "serve a single model.",
    )
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--linger-ms", type=float, default=2.0)
    p.add_argument("--bf16", action="store_true",
                   help="serve in bfloat16 (weights cast once; float32 on both wires)")
    p.add_argument(
        "--wire",
        default="float32",
        choices=WIRES,
        help="image payload dtype over the host<->device link (uint8 = a quarter "
        "of the bytes; see the module docstring)",
    )
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--head-mode", default=None, help="the RGB-Beta head's form: plain, hybrid or fused")
    p.add_argument("--mdblock-mode", default=None, help="the MDBLOCKs' form: plain or fused")
    a = p.parse_args(argv)
    common = dict(
        max_batch=a.max_batch,
        linger_ms=a.linger_ms,
        dtype=torch.bfloat16 if a.bf16 else None,
        wire=a.wire,
        device=a.device,
        head_mode=a.head_mode,
        mdblock_mode=a.mdblock_mode,
    )

    if a.model:
        server = ModelHost()
        for spec in a.model:
            name, _, rest = spec.partition("=")
            if not rest:
                raise SystemExit(f"--model {spec!r}: expected NAME=CONFIG[:WEIGHTS]")
            config, _, weights = rest.partition(":")
            server.add(name, InferenceServer(config=config, weights_path=weights or None, **common))
        what = ", ".join(sorted(server.servers))
    else:
        server = InferenceServer(config=a.config, weights_path=a.weights, **common)
        what = a.config
    httpd = serve_http(server, port=a.port)
    print(
        f"serving {what} on http://127.0.0.1:{httpd.server_address[1]} "
        "(encode/decode/healthz/stats/models)",
        flush=True,
    )
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
