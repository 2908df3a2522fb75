"""What the benchmark reads from torch.profiler's record of a traced window:
the device's activity as the union of its intervals (a kernel launched with
programmatic dependent launch has its wait inside its recorded duration, so
a sum of durations counts that wait twice), the gaps in it with the host
operation open across each, time by kernel, and the host's launch calls."""

from dataclasses import dataclass, field

from benchmark.yardstick.bounds import base_name

# CUDA API calls (the runtime's and the low-level cu* ones) that put work on the card's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")
# the benchmark's own host spans are named with this prefix
SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
TOP = 10
# host events of the profiler's own bookkeeping, not of the program
PROFILER_OWN = ("Activity Buffer Request",)


def union(intervals):
    """Merged, sorted (start, end) intervals of `intervals`."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def covered(intervals, lo, hi):
    """Length of the union of `intervals` inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


@dataclass
class Trace:
    """A traced window, times in microseconds on the profiler's clock.
    `device`: (name, start, end) of every device activity (kernels, copies,
    sets); `host`: (name, start, end) of every host operation; `launches`:
    the host's launch calls in the window; `lo`, `hi`: the window."""

    device: list
    host: list
    launches: int
    lo: float
    hi: float
    _busy: list = field(default=None, repr=False)

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e6

    def busy_intervals(self):
        if self._busy is None:
            self._busy = [(max(s, self.lo), min(e, self.hi)) for s, e in
                          union([(s, e) for _, s, e in self.device]) if e > self.lo and s < self.hi]
        return self._busy

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_seconds(self, keep):
        """Seconds of the union of the device records whose name `keep`
        accepts, and how many there were."""
        chosen = [(s, e) for name, s, e in self.device if keep(name)]
        return covered(chosen, self.lo, self.hi) / 1e6, len(chosen)

    def count(self, keep):
        """How many device records whose name `keep` accepts began inside
        the window."""
        return sum(self.lo <= s <= self.hi for name, s, _ in self.device if keep(name))

    def gaps(self):
        """(start, end) of each stretch of the window with nothing on the
        device."""
        out, t = [], self.lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def open_at(self, t):
        """What the host was doing at time t: the innermost of the
        benchmark's spans open then, and the innermost other operation."""
        span, op = None, None
        for name, s, e in self.host:
            if s <= t <= e:
                if name.startswith(SPAN_PREFIX) and name != WINDOW_SPAN:
                    if span is None or s >= span[1]:
                        span = (name, s)
                elif not name.startswith(SPAN_PREFIX) and (op is None or s >= op[1]):
                    op = (name, s)
        parts = [p[0] for p in (span, op) if p is not None]
        return "/".join(parts) if parts else "host idle"

    def breakdown(self):
        """The result line's `breakdown`: the device operations that took most
        time, by name, and the longest idle gaps by what the host was doing."""
        by_name = {}
        for name, s, e in self.device:
            key = base_name(name) if "(" in name else name
            by_name[key] = by_name.get(key, 0.0) + (min(e, self.hi) - max(s, self.lo)) / 1e6
        ops = sorted(((k, v) for k, v in by_name.items() if v > 0), key=lambda kv: -kv[1])[:TOP]
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        gaps = [[self.open_at((s + e) / 2), (e - s) / 1e6] for s, e in longest]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def from_profile(prof):
    """A Trace of a torch.profiler window whose work ran inside the
    benchmark's WINDOW_SPAN."""
    from torch.autograd import DeviceType

    device, host, launches, window = [], [], [], None
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            # the device side of a host span is the span, not work
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith(SPAN_PREFIX)):
                device.append((ev.name, s, e))
        elif ev.device_type == DeviceType.CPU:
            if ev.name == WINDOW_SPAN:
                window = (s, e)
            if ev.name not in PROFILER_OWN:
                host.append((ev.name, s, e))
            if ev.name in LAUNCH_CALLS:
                launches.append(s)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window
    return Trace(device=device, host=host, launches=sum(lo <= t <= hi for t in launches), lo=lo, hi=hi)
