"""Hand-written CUDA kernels (sources in `npe_tpu_torch/csrc/`), each beside
its plain PyTorch version. A wrapper runs the plain version for a tensor on
the CPU, and for a tensor on the GPU launches its kernel or raises.

Each wrapper counts its launches in an attribute of its own (`launches`,
and `launches_bf16` for a bf16 form) through `add_launches`, which also
counts them in the tally of the calling thread, where `tallying` keeps one:
a capture (`utils/graphs.capture`) reads what its own thread counted there,
and none of what other threads' eager calls count meanwhile."""

import contextlib
import threading

_lock = threading.Lock()
_tally = threading.local()


_THREADS = object()


def current_tally():
    """The calling thread's tally, or None where it keeps none."""
    return getattr(_tally, "counts", None)


def add_launches(fn, attr="launches", n=1, tally=_THREADS):
    """`n` more launches of `fn`'s kernel, counted in `fn.<attr>` and in the
    calling thread's tally, if it keeps one, or in `tally` where one is given
    (None: none). A backward, which autograd may run on a thread of its own,
    counts in the tally its forward's thread kept (`current_tally()` then)."""
    with _lock:
        setattr(fn, attr, getattr(fn, attr) + n)
    if tally is _THREADS:
        tally = current_tally()
    if tally is not None:
        tally[(fn, attr)] = tally.get((fn, attr), 0) + n


@contextlib.contextmanager
def tallying():
    """{(wrapper, attribute): launches} that the calling thread counts inside
    the block, filled in as it runs."""
    outer = getattr(_tally, "counts", None)
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = outer
