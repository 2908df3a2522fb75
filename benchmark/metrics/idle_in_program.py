"""The device's idle time while the host is inside the port, % of the
traced window: the part of the device's idle stretches (`Trace.gaps`) that
the union of the program's `npe.*` spans covers. `idle_share` less this is
idle time with the host outside the port: the harness, the interpreter
between calls, a thread off its core. None where the program records no
`npe.*` span at all (one older than its spans); a program that records them
but none in the window raises."""

from benchmark.metrics.host_ms import PREFIX, covered_by, has_spans, spans


def read(run):
    trace = run.profile
    if not has_spans(trace):
        return None
    inside = spans(trace, lambda name: name.startswith(PREFIX))
    if not inside:
        raise RuntimeError(f"the program records {PREFIX}* spans, but the window holds none")
    return 100.0 * covered_by(trace.gaps(), inside) / (trace.hi - trace.lo)
