"""The host's own time inside the port per unit of the cell's work (a
stroke, a batch, a training step), ms: the length of the cell's entry spans
(the program's `npe.*` spans, on the profiler's clock) inside the traced
window, less the part of them that `npe.wait` spans (the host blocked on the
card) and `npe.replay` spans (a captured program's launch, which waits for
room in the card's queue when the host runs ahead, and which the profiler
slows; `host_launches_per_stroke` counts the launches) cover, over the units
the window completed. None where the program records no `npe.*` span at all
(one older than its spans); a program that records them but none of the
cell's entry spans in the window raises, so a renamed span cannot silence
the metric."""

from bisect import bisect_left, bisect_right

from benchmark.yardstick.trace import covered, union

PREFIX = "npe."
# the entry spans of each traffic kind
ENTRY = {"edit": ("npe.paint_stroke",), "encdec": ("npe.encode_images", "npe.sample_at"),
         "train": ("npe.step.G", "npe.step.D", "npe.stage_chunk")}
# spans inside an entry that are not the host's own work
LEFT_OUT = ("npe.wait", "npe.replay")


def spans(trace, keep):
    """The union of the host spans whose name `keep` accepts, clipped to the
    window: sorted, disjoint (start, end)."""
    return [(max(s, trace.lo), min(e, trace.hi)) for s, e in
            union([(s, e) for name, s, e in trace.host if keep(name)]) if e > trace.lo and s < trace.hi]


def covered_by(intervals, cover):
    """Length of `intervals` that `cover` covers, both sorted and disjoint."""
    starts, ends = [s for s, _ in cover], [e for _, e in cover]
    return sum(covered(cover[bisect_right(ends, s):bisect_left(starts, e)], s, e) for s, e in intervals)


def has_spans(trace):
    """Whether the program recorded any of its spans in the trace."""
    return trace is not None and any(name.startswith(PREFIX) for name, _, _ in trace.host)


def read(run):
    trace = run.profile
    if not has_spans(trace):
        return None
    names = ENTRY[run.traffic["kind"]]
    entry = spans(trace, names.__contains__)
    if not entry:
        raise RuntimeError(f"the program records {PREFIX}* spans, but the window holds none of {names}")
    own = sum(e - s for s, e in entry) - covered_by(entry, spans(trace, LEFT_OUT.__contains__))
    return own / 1e3 / run.work
