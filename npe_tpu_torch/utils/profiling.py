"""Tracing / profiling utilities (npe_tpu `utils/profiling.py`): a step timer
with percentile summaries, and thin wrappers over `torch.profiler` for traces
that Perfetto and TensorBoard open."""

import contextlib
import time

import numpy as np
import torch


class StepTimer:
    """Wall-clock step timing with p50/p90/p99 summaries. The caller ends
    each timed block with the device work it waits for (a synchronize or a
    copy to the host): PyTorch returns before the card finishes."""

    def __init__(self, name="step"):
        self.name = name
        self.samples = []

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def summary(self):
        if not self.samples:
            return {}
        arr = np.asarray(self.samples) * 1000.0
        return {
            f"{self.name}_ms_p50": float(np.percentile(arr, 50)),
            f"{self.name}_ms_p90": float(np.percentile(arr, 90)),
            f"{self.name}_ms_p99": float(np.percentile(arr, 99)),
            f"{self.name}_ms_mean": float(arr.mean()),
            f"{self.name}_count": len(arr),
        }


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


@contextlib.contextmanager
def annotate(name):
    """A named region inside a trace."""
    with torch.profiler.record_function(name):
        yield
