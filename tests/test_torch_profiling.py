"""`npe_tpu_torch/utils/profiling.py` against npe_tpu's `utils/profiling.py`:
the step timer's summary, and a torch.profiler trace (here of the CPU's ops)
that holds a named region and opens as a Chrome trace."""

import json

import numpy as np
import torch

from npe_tpu.utils.profiling import StepTimer as JaxStepTimer
from npe_tpu_torch.utils import profiling


def test_step_timer_summary_matches_npe_tpu():
    samples = list(np.random.RandomState(0).uniform(0.001, 0.02, 50))
    ours, theirs = profiling.StepTimer("chunk"), JaxStepTimer("chunk")
    ours.samples, theirs.samples = list(samples), list(samples)
    assert ours.summary() == theirs.summary()
    assert profiling.StepTimer().summary() == {}
    t = profiling.StepTimer("s")
    for _ in range(3):
        with t.time():
            pass
    assert t.summary()["s_count"] == 3 and t.summary()["s_ms_p50"] >= 0


def test_device_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    x = torch.ones(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("npe_region"):
            (x @ x).sum()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "npe_region" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "npe_region" for e in prof.key_averages())
