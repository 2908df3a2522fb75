"""The port's bench scripts on the CPU: their arguments, their refusal to run
without a CUDA device, and the parts that need no card (the operation count
behind `mfu`, the stroke script and its timing loop)."""

import numpy as np
import pytest
import torch

import bench_torch
import bench_torch_edit
import torch_parity as tp
from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.models import get_config

tp.torch_threads()


@pytest.mark.parametrize("bench,argv", [
    (bench_torch, ["--models", "IAN_simple", "--iters", "1", "--repeats", "1"]),
    (bench_torch_edit, ["--models", "IAN_simple", "--strokes", "1", "--repeats", "1"]),
])
def test_exits_nonzero_without_cuda(bench, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main(argv) == 1
    out = capsys.readouterr()
    assert "needs an NVIDIA GPU" in out.err and out.out == ""  # no result line


def test_bench_torch_arguments():
    a = bench_torch.parse([])
    assert (a.dtype, a.batch) == ("bfloat16", 256)  # bench.py's headline: bf16 at batch 256
    assert [m for m, _ in a.forms] == ["IAN_simple", "IANv1", "IANv1", "IAN", "IAN"]
    a = bench_torch.parse(["--dtype", "float32", "--models", "IANv1", "--batch", "64"])
    assert a.dtype == "float32" and a.batch == 64 and a.forms == [("IANv1", {"head_mode": "hybrid"}),
                                                                  ("IANv1", {"head_mode": "fused"})]
    for bad in (["--dtype", "float16"], ["--models", "IAN_simple,VGG"], ["--batch", "0"], ["--repeats", "0"]):
        with pytest.raises(SystemExit):
            bench_torch.parse(bad)


def test_bench_torch_edit_arguments():
    a = bench_torch_edit.parse([])
    assert a.dtypes == ["float32", "bfloat16"] and len(a.forms) == 5 and a.strokes == 100
    a = bench_torch_edit.parse(["--dtypes", "bfloat16", "--models", "IAN"])
    assert a.dtypes == ["bfloat16"] and a.forms == [("IAN", {"mdblock_mode": "plain"}),
                                                    ("IAN", {"mdblock_mode": "fused"})]
    for bad in (["--dtypes", "float16"], ["--models", "IANv2"], ["--strokes", "0"]):
        with pytest.raises(SystemExit):
            bench_torch_edit.parse(bad)


def _conv(h, w, cin, cout, k=5):
    return 2 * h * w * cin * cout * k * k


def test_flops_per_image_counts_the_models_products():
    """The tiny IAN_simple: every conv, deconv and dense product of one
    encode (both latent heads) and one decode, two operations a
    multiply-add; elementwise work is not counted."""
    module = get_config(tp.TINY_TORCH)
    v = tp.port_variables(tp.TINY_JAX)
    enc = (_conv(32, 32, 3, 16) + _conv(16, 16, 16, 32) + _conv(8, 8, 32, 64) + _conv(4, 4, 64, 128)
           + 2 * 128 * 16 * 64 + 2 * (2 * 64 * 16))
    dec = 2 * 16 * 128 * 16 + _conv(4, 4, 128, 64) + _conv(8, 8, 64, 32) + _conv(16, 16, 32, 16) + _conv(32, 32, 16, 3)
    assert bench_torch.flops_per_image(module, v, {}) == enc + dec


def test_flops_per_image_of_the_kernel_forms_are_their_plain_versions():
    """The fused MDBLOCK's plain version takes each tap's product once; the
    per-op form's convs take its composed kernels' structural zeros too, and
    it composes each MDCL's kernel from its branches by one product a decode
    (`compose_mdcl_kernel`). The same encode either way."""
    module = get_config(tp.TINY_FULL_TORCH)
    v = tp.port_variables(tp.TINY_FULL_JAX)
    per_op = bench_torch.flops_per_image(module, v, {"mdblock_mode": "plain"})
    fused = bench_torch.flops_per_image(module, v, {"mdblock_mode": "fused"})
    # (size, channels, branches, the composed kernel's taps, the nonzero taps) of the three MDBLOCKs
    blocks = [(8, 64, 3, 25, 18), (16, 32, 4, 49, 27), (32, 16, 4, 49, 27)]
    zeros = sum(2 * 2 * s * s * c * c * (dense - taps) for s, c, _, dense, taps in blocks)
    composing = sum(2 * 2 * c * c * 9 * b * dense for _, c, b, dense, _ in blocks)
    assert per_op - fused == zeros + composing


def test_stroke_script_and_stroke_times_on_a_cpu_session():
    strokes = bench_torch_edit.stroke_script()
    assert len(strokes) == 16 and strokes == bench_torch_edit.stroke_script()
    assert all(0 <= x1 < x2 <= 64 and 0 <= y1 < y2 <= 64 and 4 <= x2 - x1 <= 20 for x1, y1, x2, y2, _, _ in strokes)
    assert [s[5] for s in strokes[:4]] == [0.0, 0.5, 0.0, 0.5]
    session = EditSession(tp.TINY_TORCH, variables=tp.port_variables(tp.TINY_JAX), dim=(4, 4), device="cpu",
                          dtype="bfloat16")
    image = np.zeros((3, 64, 64), np.float32)
    times = bench_torch_edit.stroke_times(session, image, 3, warm=1)
    assert len(times) == 3 and all(t > 0 for t in times) and len(session._undo) == 4
