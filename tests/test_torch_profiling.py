"""`npe_tpu_torch/utils/profiling.py`: a torch.profiler trace (here of the
CPU's ops) that holds a named region and opens as a Chrome trace. The spans
themselves are tests/test_torch_tracing.py's."""

import json

import torch

from npe_tpu_torch.utils import profiling


def test_device_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    x = torch.ones(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("npe_region"):
            (x @ x).sum()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "npe_region" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "npe_region" for e in prof.key_averages())
