"""Captured programs: a function over fixed tensors as one CUDA graph, the
port's counterpart of a jitted `npe_tpu` program. The trainer's G and D
steps (`training/captured.py`) and the editor's stroke, scroll and latent
composite (`editor/captured.py`) run through `Program`.

Launch counters. The kernel wrappers count a launch when Python calls them.
An eager call launches what it counts. A capture launches nothing, so it
puts the counts back as they were before it and keeps what it added
(`recorded`); a replay launches the captured kernels without calling the
wrappers, so every replay adds `recorded`. The counts are thus the launches
the card ran, provided the graph holds the kernels the capture counted;
`chip_smoke.py` holds them against the device kernels that torch.profiler
records in the same run.

The capture mode. `Program.capture_error_mode` is "thread_local": a capture
refuses the unsafe CUDA calls (a synchronise, a cudaMalloc) of its own
thread only. Under torch's default, "global", such a call on any other
thread of the process invalidates a capture under way, and the editor
captures on the web editor's request threads beside others
(`editor/captured.py`). The trainer's programs keep "global"
(`training/captured.py`).

Freeing inside a capture. A graph, or its pool's memory, freed while another
capture runs calls cudaFree, which invalidates that capture. `capture` keeps
Python's cyclic collector off while it captures, and the objects that own
programs hold no reference cycle, so they free their graphs when they go.

Failure raises. A capture or a replay that fails raises; nothing falls back
to eager calls.
"""
import contextlib
import gc

import torch

from npe_tpu_torch.ops.kernels import edit_tail, mdblock, rgb_beta_head, rgb_beta_tail, staging

# Every launch count of the kernel wrappers: (wrapper, attribute).
COUNTERS = tuple((fn, attr) for fn in (edit_tail.edit_tail, mdblock.mdblock_fused, rgb_beta_head.rgb_beta_head,
                                       rgb_beta_tail.rgb_beta_tail, staging.stage_chunk)
                 for attr in ("launches", "launches_bf16") if hasattr(fn, attr))


def read_counts():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def add_counts(delta):
    for (fn, attr), n in zip(COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + n)


def capture(body, stream, pool, capture_error_mode=None):
    """A CUDA graph of `body` captured on `stream` into `pool`, and the
    launches the capture counted, which it takes back off the counters.
    Python's cyclic garbage collector is off while it captures: a collection
    there that frees another graph, or the memory of its pool, calls
    cudaFree, which invalidates the capture. `capture_error_mode` is
    `torch.cuda.graph`'s; None leaves torch's default, "global"."""
    before = read_counts()
    graph = torch.cuda.CUDAGraph()
    mode = {} if capture_error_mode is None else {"capture_error_mode": capture_error_mode}
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream, **mode):
            body()
    finally:
        if collecting:
            gc.enable()
        recorded = [n - b for n, b in zip(read_counts(), before)]
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

    `calls` and `captures` count the calls and the captures (at most one).
    `capture_error_mode` goes to `capture` (see the module docstring)."""

    capture_error_mode = "thread_local"

    def __init__(self, body, stream=None, pool=None, pure=False):
        self.body, self.stream, self.pool, self.pure = body, stream, pool, pure
        self.calls, self.captures, self.graph, self.recorded = 0, 0, None, None

    def _stream(self):
        """The context of an eager call on the card."""
        return _on(self.stream)

    def _capture(self):
        self.captures += 1
        self.graph, self.recorded = capture(self.body, self.stream, self.pool, self.capture_error_mode)

    def __call__(self):
        self.calls += 1
        if self.stream is None:
            self.body()
            return
        if self.graph is None and self.calls == 1:
            with self._stream():
                self.body()
            if self.pure:
                self._capture()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        add_counts(self.recorded)
