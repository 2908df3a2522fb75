"""Captured programs: a function over fixed tensors as one CUDA graph, the
port's counterpart of a jitted `npe_tpu` program. The trainer's G and D
steps (`training/captured.py`) and the editor's steps (`editor/captured.py`)
run through `Program`; `ProgramCache`, the counterpart of `jax.jit` for pure
functions of their inputs, keeps one `Program` per input signature, and runs
`api.IAN`'s four methods, the server's encode and decode, and the sampling
and evaluation programs of `training/programs.py`.

Launch counters. The kernel wrappers count a launch when Python calls them.
An eager call launches what it counts. A capture launches nothing, so it
takes back what its own thread counted while it ran (`ops.kernels.tallying`:
other threads' eager launches meanwhile stay counted) and keeps it
(`recorded`); a replay launches the captured kernels without calling the
wrappers, so every replay adds `recorded`. The counts are thus the launches
the card ran, provided the graph holds the kernels the capture counted;
`chip_smoke.py` holds them against the device kernels that torch.profiler
records in the same run.

The capture mode is "thread_local": a capture refuses the unsafe CUDA calls
(a synchronise, a cudaMalloc) of its own thread only. Under torch's default,
"global", such a call on any other thread of the process invalidates a
capture under way, and a process captures on several threads: the web
editor's request threads, a `ModelHost`'s dispatchers (one a model), API
callers and the trainer beside its asynchronous checkpoint thread. Their
captures take turns (one process-wide lock); their eager calls do not wait.

Freeing inside a capture. A graph, or its pool's memory, freed while a
capture runs calls cudaFree, which invalidates that capture. `capture` keeps
Python's cyclic collector off while it captures (captures take turns, so
the collector is off from the start of each to its end), and the objects
that own programs hold no reference cycle, so they free their graphs when
they go.

Failure raises. A capture or a replay that fails raises; nothing falls back
to eager calls.

Spans (`utils/profiling.py`, recorded only under a profiler). A `Program`'s
call is `npe.eager` (a first call, or any call on the CPU), `npe.capture` or
`npe.replay`; a `ProgramCache` call adds `npe.stage` (its inputs staged,
uploaded and copied in), `npe.wait` (each synchronise) and `npe.unpack` (its
outputs copied into the caller's own). Each wraps a call from the host, never
a line of a captured body, so a graph holds the same kernels with or without
a profiler.
"""
import contextlib
import gc
import threading
import time
import weakref

import numpy as np
import torch

from npe_tpu_torch.ops.kernels import add_launches, edit_tail, mdblock, rgb_beta_head, rgb_beta_tail, staging, tallying
from npe_tpu_torch.utils.profiling import annotate

# Every launch count of the kernel wrappers: (wrapper, attribute).
COUNTERS = tuple((fn, attr) for fn in (edit_tail.edit_tail, mdblock.mdblock_fused, rgb_beta_head.rgb_beta_head,
                                       rgb_beta_tail.rgb_beta_tail, staging.stage_chunk)
                 for attr in ("launches", "launches_bf16", "launches_bwd", "launches_bwd_bf16") if hasattr(fn, attr))


def read_counts():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def add_counts(delta):
    for (fn, attr), n in zip(COUNTERS, delta):
        add_launches(fn, attr, n)


_capturing = threading.Lock()  # one capture at a time in the process


@contextlib.contextmanager
def _collector_off():
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def capture(body, stream, pool):
    """A CUDA graph of `body` captured on `stream` into `pool` in
    "thread_local" mode, and the launches the capture counted on this
    thread, which it takes back off the counters (also when it fails).
    Captures take turns, and Python's cyclic garbage collector is off while
    one runs: a collection there that frees another graph, or the memory of
    its pool, calls cudaFree, which invalidates the capture."""
    graph = torch.cuda.CUDAGraph()
    with _capturing, _collector_off(), tallying() as tally:
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                body()
        finally:
            recorded = [tally.get(c, 0) for c in COUNTERS]
            add_counts([-n for n in recorded])
    return graph, recorded


@contextlib.contextmanager
def _on(stream):
    """Work on `stream`, ordered after and before the current stream's."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


class Program:
    """`body`, a function of no arguments over fixed tensors, as a CUDA graph
    on the card. On the CPU (`stream` None) every call runs `body`.

    The first call runs `body` eagerly on `stream`, the capture's: a real
    call, which also warms the libraries up and makes the kernels' host-side
    set-up (their first-launch calls) outside any capture. A body that
    updates what it reads (the trainer's step, `pure` False) is captured at
    its second call, and the graph replayed then and at every later call. A
    `pure` body, whose outputs are a function of its inputs alone (the
    editor's steps), is captured right after its eager first call, whose
    outputs stand (a capture runs nothing), and replayed at every later
    call. So each call runs its body once on the card, and each kind is
    captured at its first call.

    `calls` and `captures` count the calls and the captures (at most one)."""

    def __init__(self, body, stream=None, pool=None, pure=False):
        self.body, self.stream, self.pool, self.pure = body, stream, pool, pure
        self.calls, self.captures, self.graph, self.recorded = 0, 0, None, None

    def _capture(self):
        self.captures += 1
        with annotate("npe.capture"):
            self.graph, self.recorded = capture(self.body, self.stream, self.pool)

    def __call__(self):
        self.calls += 1
        if self.stream is None:
            with annotate("npe.eager"):
                self.body()
            return
        if self.graph is None and self.calls == 1:
            with annotate("npe.eager"), _on(self.stream):
                self.body()
            if self.pure:
                self._capture()
            return
        if self.graph is None:
            self._capture()
        with annotate("npe.replay"):
            self.graph.replay()
            add_counts(self.recorded)


# byte alignment of each tensor in a signature's packed buffers (cudaMalloc's)
ALIGN = 256


def _layout(specs):
    """Byte offsets of tensors of `specs` [(shape, dtype)] packed back to back
    into one buffer, each at a multiple of ALIGN, and the buffer's size."""
    offsets, total = [], 0
    for shape, dtype in specs:
        offsets.append(total)
        total += -(-int(np.prod(shape, dtype=np.int64)) * dtype.itemsize // ALIGN) * ALIGN
    return offsets, total


def _views(buffer, specs, offsets):
    """Typed views of `specs` into the uint8 `buffer` at `offsets`."""
    return [buffer[o:o + int(np.prod(s, dtype=np.int64)) * d.itemsize].view(d).view(s)
            for (s, d), o in zip(specs, offsets)]


class Signature:
    """One input signature of a `ProgramCache` function: the static inputs,
    packed into one device buffer (one copy uploads them from one pinned
    staging buffer), the static outputs, packed into another (one copy
    downloads them into a pinned buffer), and the `Program` whose body runs
    the function on them. `first_call_ms` is the host time of the call that
    made it (on the card the eager call and the capture, upload and download
    included). `uploaded` marks the end of the last upload from the staging
    buffer on the card, which a call that downloads nothing does not wait
    for."""

    def __init__(self, device, specs, program):
        offsets, total = _layout(specs)
        with torch.inference_mode(False):  # buffers that a gradient body may read as leaves
            self.buffer = torch.empty(total, dtype=torch.uint8, device=device)
            self.inputs = _views(self.buffer, specs, offsets)
        self.staging = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.staged = [v.numpy() for v in _views(self.staging, specs, offsets)]
        self.uploaded = torch.cuda.Event() if device.type == "cuda" else None
        self.outputs = self.host_outputs = None
        self.program, self.first_call_ms = program, None

    def keep(self, outs):
        """Static outputs shaped as `outs` (the first call's results); the
        first call makes them, outside any capture."""
        specs = [(tuple(o.shape), o.dtype) for o in outs]
        offsets, total = _layout(specs)
        device = outs[0].device
        with torch.inference_mode(False):
            self.out_buffer = torch.empty(total, dtype=torch.uint8, device=device)
            self.outputs = _views(self.out_buffer, specs, offsets)
        self.out_staging = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.host_outputs = [v.numpy() for v in _views(self.out_staging, specs, offsets)]


class ProgramCache:
    """The counterpart of `jax.jit` for an owner's pure functions of tensors:
    one `Signature` (static buffers and a pure `Program`, captured once) per
    function and input signature, the inputs' shapes and dtypes, as `jax.jit`
    keeps one program per shape. A new signature's first call runs
    the function eagerly on the capture's stream and gives the result, then
    captures it ("thread_local", as every `Program`); every later call of
    that signature uploads its inputs, replays the graph and copies the
    outputs out. Values never make a new signature: a moved brush box, a new
    colour or new latents are inputs.

    `define(name, fn)` names a function; fn takes the static inputs as
    tensors on `device`, in the caller's order, and returns a tensor or a
    tuple of tensors of numpy dtypes, which die or are copied out inside the
    call. fn is a bound method of the owner, held by a weak reference: an
    owner that holds its cache forms no reference cycle, and its graphs go
    with it (see the module docstring). `cache(name, *args)` runs it: args
    are host arrays (a CPU tensor is one), staged into the pinned buffer and
    uploaded in one copy, or tensors on the cache's device, each copied into
    its buffer there; `pad_to` pads their first axis with
    zero rows to that length, and the outputs' first axis is cut back to the
    rows given. Returns the outputs as numpy arrays of their own, one output
    bare, after one download and one synchronise; with `download=False`, as
    new tensors on the cache's device, without a synchronise (a later call
    waits for this one's upload before it stages again). A lock makes a call
    atomic, so threads may share a cache; the caller's current stream orders
    it.

    All signatures share one memory pool: they never run at once, and every
    tensor a function allocates dies inside its call. On the CPU, and with
    `eager=True` on the card, the same bodies run directly on the same
    buffers. `first_calls` counts the calls that made a signature (on the
    card, an eager call and a capture each); a failing first call raises and
    leaves no signature. Nothing falls back to eager calls."""

    def __init__(self, device, eager=False):
        self.device = torch.empty(0, device=device).device  # "cuda" as the card's index
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" and not eager else None
        self.pool = torch.cuda.graph_pool_handle() if self.stream is not None else None
        self.functions, self.signatures = {}, {}
        self.lock = threading.Lock()
        self.first_calls = 0

    def define(self, name, fn):
        self.functions[name] = weakref.WeakMethod(fn)

    def captures(self, name=None):
        """{signature key: captures (0 or 1)} of `name`'s signatures (all
        functions' with None)."""
        return {key: s.program.captures for key, s in self.signatures.items() if name in (None, key[0])}

    def _body(self, key):
        sig = self.signatures[key]
        outs = self.functions[key[0]]()(*sig.inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        if sig.outputs is None:
            sig.keep(outs)
        for dst, src in zip(sig.outputs, outs):
            dst.copy_(src)

    def _input(self, a):
        """A tensor on this cache's device as it is, anything else as a host
        array (a CPU tensor as its array; one on another device raises)."""
        if isinstance(a, torch.Tensor):
            a = a.detach()
            if a.device == self.device:
                return a
        return np.asarray(a)

    def __call__(self, name, *args, pad_to=None, download=True):
        args = [self._input(a) for a in args]
        rows = None
        specs = []
        for a in args:
            shape = tuple(a.shape)
            if pad_to is not None:
                rows = shape[0] if rows is None else rows
                if shape[0] != rows or rows > pad_to:
                    raise ValueError(f"{name}: {shape[0]} rows where {rows} at most {pad_to} were expected")
                shape = (pad_to,) + shape[1:]
            dtype = a.dtype if isinstance(a, torch.Tensor) else torch.from_numpy(np.empty(0, a.dtype)).dtype
            specs.append((shape, dtype))
        key = (name, tuple(specs))
        cut = ... if rows is None else slice(0, rows)
        with self.lock:
            t0 = time.perf_counter()
            sig = self.signatures.get(key)
            if sig is None:
                me = weakref.ref(self)
                sig = Signature(self.device, specs, Program(lambda: me()._body(key), self.stream, self.pool, pure=True))
                self.signatures[key] = sig
            staged = [(view, a) for view, a in zip(sig.staged, args) if not isinstance(a, torch.Tensor)]
            if staged and sig.uploaded is not None:
                with annotate("npe.wait"):
                    sig.uploaded.synchronize()  # the staging buffer is free again
            with annotate("npe.stage"):
                if staged:
                    for view, a in staged:
                        if rows is None:
                            view[...] = a
                        else:
                            view[:rows] = a
                            view[rows:] = 0
                    sig.buffer.copy_(sig.staging, non_blocking=True)
                    if sig.uploaded is not None:
                        sig.uploaded.record()
                with torch.no_grad():
                    for view, a in zip(sig.inputs, args):
                        if isinstance(a, torch.Tensor) and rows is None:
                            view.copy_(a)
                        elif isinstance(a, torch.Tensor):
                            view[:rows].copy_(a)
                            view[rows:].zero_()
            cold = sig.program.calls == 0
            try:
                sig.program()
            except BaseException:
                if cold:
                    del self.signatures[key]
                raise
            finally:
                self.first_calls += cold
            if download:
                sig.out_staging.copy_(sig.out_buffer, non_blocking=True)
                if self.device.type == "cuda":
                    with annotate("npe.wait"):
                        torch.cuda.current_stream(self.device).synchronize()
                with annotate("npe.unpack"):
                    outs = tuple(o[cut].copy() for o in sig.host_outputs)
            else:
                with annotate("npe.unpack"), torch.no_grad():
                    outs = tuple(o[cut].clone() for o in sig.outputs)
            if cold:
                sig.first_call_ms = (time.perf_counter() - t0) * 1e3
        return outs[0] if len(outs) == 1 else outs
