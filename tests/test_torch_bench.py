"""The port's bench scripts on the CPU: their arguments, their refusal to run
without a CUDA device, and the parts that need no card (the operation counts
behind `mfu`, the training step's held to bench.py's, the stroke script and
its timing loop, the stage profile's multiply-add counts against the
reference script's and its stages on the tiny profile)."""

import inspect
import sys

import numpy as np
import pytest
import torch

import bench_stages
import bench_torch
import bench_torch_edit
import bench_torch_serving
import bench_torch_stages
import bench_torch_train
import torch_parity as tp
from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.models import get_config

tp.torch_threads()


@pytest.mark.parametrize("bench,argv", [
    (bench_torch, ["--models", "IAN_simple", "--iters", "1", "--repeats", "1"]),
    (bench_torch_edit, ["--models", "IAN_simple", "--strokes", "1", "--repeats", "1"]),
    (bench_torch_stages, ["--batch", "1", "--iters", "1", "--rounds", "1"]),
    (bench_torch_train, ["--batch", "4", "--pairs", "1", "--rounds", "1"]),
    (bench_torch_serving, ["--n", "1", "--repeats", "1", "--load", "0"]),
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


def test_bench_torch_train_takes_bench_train_flags_and_defaults(monkeypatch, capsys):
    """The same flags, parsed to the same run() keywords, with the same
    defaults in the parser and in run() itself."""
    import bench_train

    defaults = {k: p.default for k, p in inspect.signature(bench_train.run).parameters.items()}
    seen = []
    monkeypatch.setattr(bench_train, "run", lambda **kw: seen.append(kw) or {})
    for argv in ([], ["--model", "IAN", "--batch", "16", "--pairs", "3", "--rounds", "2", "--compute-dtype",
                      "bfloat16", "--moments-dtype", "bfloat16", "--lr", "0"]):
        monkeypatch.setattr(sys, "argv", ["bench_train.py"] + argv)
        bench_train.main()
        assert vars(bench_torch_train.parse(argv)) == seen[-1]
    assert seen[0] == {"model": "IAN_simple", "batch": 128, "pairs": 15, "rounds": 5, "compute_dtype": None,
                       "lr": 2e-4, "moments_dtype": None}
    assert {k: p.default for k, p in inspect.signature(bench_torch_train.run).parameters.items()} == defaults
    for bad in (["--model", "VGG"], ["--pairs", "0"], ["--compute-dtype", "float16"]):
        with pytest.raises(SystemExit):
            bench_torch_train.parse(bad)


@pytest.mark.parametrize("model,key", [("IAN_simple", "IAN_simple_train"), ("IAN", "IAN_train")])
def test_train_step_operation_count_against_bench_py(model, key, monkeypatch):
    """The operations of a G and a D step per image (bench_torch_train's
    count behind `mfu`, at full width) against bench.py's figures for
    npe_tpu's steps (XLA's cost analysis). The port counts every tap of a
    kernel at every output (FlopCounterMode), XLA's analysis only the taps
    that meet the input: the 5x5 convolutions of these models on 8x8 and 4x4
    maps lose a quarter and more of their taps to the padding. So the port's
    count lies 15 to 20 % above npe_tpu's for a whole step as for inference
    (bench_torch.py's IAN_simple encode + decode counts 2.592e9 against
    bench.py's 2.185e9, 1.19x), and is held within [1.12, 1.26]x. Full IAN
    is counted with its MDCLs in npe_tpu's form ('auto', `npe_tpu/ops/mdcl.py`:
    one dilated 3x3 conv per branch for a 7x7 composed kernel); the port's
    own composed 7x7 kernels multiply 49 taps where 27 are not zero."""
    import bench
    from npe_tpu_torch.models import common
    from npe_tpu_torch.ops import mdcl

    composed = common.mdcl_apply

    def npe_tpu_form(x, w, coeff_base, scale_coeffs, scales):
        branch = mdcl.mdcl_kernel_size(scales) >= 7
        return (mdcl.mdcl_apply_branch if branch else composed)(x, w, coeff_base, scale_coeffs, scales)

    monkeypatch.setattr(common, "mdcl_apply", npe_tpu_form)
    ratio = bench_torch_train.flops_per_image.__wrapped__(model) / bench.FLOPS_PER_IMG[key]
    assert 1.12 <= ratio <= 1.26, ratio


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


def test_bench_torch_edit_paths():
    """Both paths by default, the captured one first (the session's path and
    the headline); either alone; a path it does not know, or one named twice,
    is refused."""
    a = bench_torch_edit.parse([])
    assert a.paths == ["captured", "eager"] and a.dtypes == ["float32", "bfloat16"] and len(a.forms) == 5
    assert bench_torch_edit.parse(["--path", "eager"]).paths == ["eager"]
    assert bench_torch_edit.parse(["--path", "eager,captured", "--models", "IANv1"]).paths == ["eager", "captured"]
    for bad in (["--path", "graph"], ["--path", "captured,captured"], ["--path", ""]):
        with pytest.raises(SystemExit):
            bench_torch_edit.parse(bad)


def test_bench_torch_edit_times_each_path_of_a_cpu_session(monkeypatch):
    """`time_path` over a CPU session (the card's synchronise stubbed): the
    keys of a result's path; the profiler's device figures are None without a
    card."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    session = EditSession(tp.TINY_TORCH, variables=tp.port_variables(tp.TINY_JAX), dim=(4, 4), device="cpu",
                          eager=True)
    got = bench_torch_edit.time_path(session, np.zeros((3, 64, 64), np.float32), 2, 2)
    assert len(got["runs_p50_ms"]) == 2 and got["p50_ms"] > 0 and got["p95_ms"] >= got["p50_ms"] * 0.5
    assert (got["device_ms_per_stroke"], got["idle_share"], got["host_launches_per_stroke"]) == (None, None, None)


def test_bench_torch_serving_paths():
    """Both paths by default, the captured one first (the server's path and
    the headline); either alone; a path it does not know, or one named
    twice, is refused."""
    assert bench_torch_serving.parse([]).paths == ["captured", "eager"]
    assert bench_torch_serving.parse(["--path", "eager"]).paths == ["eager"]
    assert bench_torch_serving.parse(["--path", "eager,captured"]).paths == ["eager", "captured"]
    for bad in (["--path", "graph"], ["--path", "captured,captured"], ["--path", ""]):
        with pytest.raises(SystemExit):
            bench_torch_serving.parse(bad)


@pytest.mark.parametrize("eager", [False, True])
def test_bench_torch_serving_times_each_path_of_a_cpu_server(eager):
    """`run_path` over a CPU server: the figures of every run and their
    median, the buckets whose programs were made and each one's first call;
    no capture without a card."""
    from npe_tpu_torch.serving import InferenceServer

    server = InferenceServer(tp.TINY_TORCH, variables=tp.port_variables(tp.TINY_JAX), device="cpu", max_batch=4,
                             eager=eager)
    try:
        got = bench_torch_serving.run_path(server, 2, 3, 2)
    finally:
        server.close()
    assert len(got["runs"]) == 2 and got["median"]["decode_p50_ms"] > 0 and got["median"]["load_req_per_s"] > 0
    assert got["buckets"]["decode"] == [1] and 1 in got["buckets"]["encode"]
    assert set(got["buckets"]["encode"]) <= {1, 2, 4} and got["captures"] == 0
    assert sorted(got["first_call_ms"]) == sorted(f"{op} {b}" for op, bs in got["buckets"].items() for b in bs)
    assert all(ms > 0 for ms in got["first_call_ms"].values())
    assert got["stats"]["errors"] == 0


def test_bench_torch_stages_arguments():
    a = bench_torch_stages.parse([])
    # the reference's defaults: full IAN in bf16 at batch 128; the port's default forms
    assert (a.batch, a.dtype, a.mdblock_mode, a.head_mode, a.iters, a.rounds) == (128, "bfloat16", "plain",
                                                                                  "hybrid", 10, 5)
    a = bench_torch_stages.parse(["--dtype", "float32", "--mdblock-mode", "fused", "--head-mode", "fused",
                                  "--batch", "256"])
    assert (a.dtype, a.mdblock_mode, a.head_mode, a.batch) == ("float32", "fused", "fused", 256)
    for bad in (["--dtype", "float16"], ["--mdblock-mode", "branch"], ["--head-mode", "s2d"], ["--batch", "0"],
                ["--rounds", "0"], ["--mdcl-mode", "fused"]):
        with pytest.raises(SystemExit):
            bench_torch_stages.parse(bad)


def test_stage_macs_are_the_reference_scripts():
    """Full IAN's widths give each stage the multiply-adds that
    bench_stages.py:94-147 writes out for it, stage by stage and by name."""
    cm, zdim = bench_stages.conv_macs, 100
    want = {
        "encode(total)": cm(32, 75, 1, 128) + cm(16, 25, 128, 256) + cm(8, 25, 256, 512) + cm(4, 25, 512, 1024)
        + 16384 * 1000 + 2 * 1000 * zdim,
        "decode(total)": None,
        "fc2+unflatten": zdim * 8192,
        "deconv1 512->512 @8": cm(8, 25, 512, 512) // 4,
        "mdblock2a @8 512 [0,2]": 2 * cm(8, 25, 512, 512),
        "deconv2 512->256 @16": cm(16, 25, 512, 256) // 4,
        "mdblock3a @16 256 [0,2,3]": 2 * cm(16, 49, 256, 256),
        "deconv3 256->128 @32": cm(32, 25, 256, 128) // 4,
        "mdblock4a @32 128 [0,2,3]": 2 * cm(32, 49, 128, 128),
        "deconv4+bn 128->128 @64": cm(64, 25, 128, 128) // 4,
        "rgb_beta_head @64": cm(64, 81, 128, 6) + cm(64, 81, 2, 2) + cm(64, 81, 4, 2),
    }
    got = bench_torch_stages.stage_macs((128, 256, 512, 1024), 1000, (512, 512, 256, 128, 128), zdim)
    assert list(got) == list(want) and got == want


@pytest.mark.parametrize("mdblock_mode,head_mode", [("plain", "hybrid"), ("fused", "fused")])
def test_stages_run_on_the_tiny_profile(mdblock_mode, head_mode):
    """Every stage of the profile is a call of the port's own functions: on
    the tiny full-IAN profile on the CPU each gives a finite map of its
    stage's shape, in the reference's order, the same from both forms."""
    module = get_config(tp.TINY_FULL_TORCH)
    v = tp.port_variables(tp.TINY_FULL_JAX)
    enc, fc, dec = bench_torch_stages.widths(v)
    assert (enc, fc, dec) == ((16, 32, 64, 128), 64, (64, 64, 32, 16, 16))
    rows = bench_torch_stages.stages(module, v, 2, torch.float32, "cpu", mdblock_mode, head_mode)
    shapes = [(2, 16), (2, 3, 64, 64), (2, 64, 4, 4), (2, 64, 8, 8), (2, 64, 8, 8), (2, 32, 16, 16),
              (2, 32, 16, 16), (2, 16, 32, 32), (2, 16, 32, 32), (2, 16, 64, 64), (2, 3, 64, 64)]
    assert [name for name, _, _ in rows] == list(bench_torch_stages.stage_macs(enc, fc, dec, 16))
    with torch.no_grad():
        for (name, fn, macs), shape in zip(rows, shapes):
            out = fn()
            assert tuple(out.shape) == shape and bool(torch.isfinite(out).all()), name
            assert (macs is None) == (name == "decode(total)")
