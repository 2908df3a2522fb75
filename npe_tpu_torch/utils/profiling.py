"""Tracing / profiling utilities: thin wrappers over `torch.profiler` for
traces that Perfetto and TensorBoard open, and the port's one span.

Spans. `annotate("npe.<name>")` names a stretch of the host's work inside
the port on the paths that the benchmark's cells and the trainer's
`--profile-dir` traces run: the entry points (`EditSession.paint_stroke`,
`api.IAN.encode_images` and `sample_at`, the trainer's steps, `stage_chunk`
and chunks), a `Program`'s call (`npe.eager`, `npe.capture`, `npe.replay`),
the staging of its inputs (`npe.stage`), the copy of its outputs into the
caller's arrays (`npe.unpack`) and each place there where the host blocks
on the card (`npe.wait`). The other entries carry no span of their own
until something reads one. A span records
`torch.profiler.record_function` only while a torch profiler runs, so it is
on the profiler's clock, the kernels' own, and nests under the span that
caused it on the same thread. Otherwise it is one shared null context and
costs a flag read. A span only marks the host: it takes and makes no
tensor, issues no work, event or synchronise on the card, and none sits
inside a body that a `Program` captures.
"""

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

# what `annotate` returns while no profiler runs
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(log_dir):
    """`with device_trace(dir): step(...)` records the host's ops and, where
    there is a card, its kernels, and writes one `<host>_<pid>.<ms>.pt.trace.json`
    into `dir` (`torch.profiler.tensorboard_trace_handler`): a Chrome trace
    that Perfetto (ui.perfetto.dev) opens, and TensorBoard's PyTorch profiler
    plugin reads from `dir`. Yields the profiler, whose `key_averages()` sums
    the same events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def annotate(name):
    """A span named `name` (the port's start with `npe.`): a
    `torch.profiler.record_function` while a torch profiler runs, else the
    shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
