"""Append-only JSONL metrics stream (the port's own copy of npe_tpu
`utils/metrics_logging.py`; framework-free).

Keeps the reference's observable contract (`metrics_logging.py:8-40`): one
JSON object per line, a `_stamp` epoch-time on every record, delete-on-init
when not resuming, and a reader that tolerates a torn trailing line from a
crashed writer. The implementation is this framework's own: a frozen
dataclass handle, records written with explicit flush so a kill mid-epoch
loses at most the in-flight line, and an iterator-based reader."""

import json
import os
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class MetricsLogger:
    fname: str
    reinitialize: bool = False

    def __post_init__(self):
        path = str(self.fname)
        object.__setattr__(self, "fname", path)
        if self.reinitialize and os.path.exists(path):
            print(f"{path} exists, deleting")
            os.remove(path)

    def log(self, record=None, **fields):
        """Append one record (single-writer assumption, like the reference)."""
        rec = {**(record or {}), **fields, "_stamp": time.time()}
        line = json.dumps(rec, ensure_ascii=True)
        with open(self.fname, "a") as fh:
            fh.write(line + "\n")
            fh.flush()


def iter_records(fname):
    """Yield records one by one; silently stop counting a torn/corrupt line
    (a crashed writer can only tear the tail)."""
    with open(fname) as fh:
        for raw in fh:
            if not raw.endswith("\n"):
                yield None
                continue
            try:
                yield json.loads(raw)
            except ValueError:
                yield None


def read_records(fname):
    """All intact records in the file; reports how many lines were skipped."""
    out, bad = [], 0
    for rec in iter_records(fname):
        if rec is None:
            bad += 1
        else:
            out.append(rec)
    if bad:
        print(f"skipped {bad} torn/corrupt lines in {fname}")
    return out
