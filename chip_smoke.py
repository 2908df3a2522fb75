"""Smoke run of npe_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of the repository

It builds the port's CUDA kernels from `npe_tpu_torch/csrc/` (one nvcc per
source, all at once), holds each against its plain PyTorch version on the
card, drives the Neural Photo Editor's edit path through `EditSession` and
the model API on IAN_simple, on IANv1 and on full IAN (full width, seeded
random weights at unit gain; IANv1 with the RGB-Beta head in both kernel
forms, full IAN with its MDBLOCKs in the fused and the per-op form; each
stroke, scroll and latent edit one replayed CUDA graph, `editor/captured.py`),
holds the card's results against the port on the CPU and against the same
steps run eagerly on the card (bit for bit under deterministic algorithms,
each program captured once while the brush moves), holds the kernels'
launch counts of each edit script to the device kernels that torch.profiler
records in the same run, and times the edit step captured and eager, the
kernels (among them the RGB-Beta head's backward kernels, the tail's and
x's gradient of the fused head, beside the plain VJP they replace) and
encode+decode. The editor's load, sample and decode run as two
more captured programs. `api.IAN`'s four methods run as one captured program
per input shape (`utils/graphs.ProgramCache`): for every model, form and
dtype the API script (the box moved and resized, the colour and latents
changed) is held bit for bit against `eager=True` under deterministic
algorithms, one capture a signature, its launches held to the profiler's
kernels; the inference-mode trap runs in a process of its own
(`--trap`). Then serving on the same weights: an `InferenceServer` per
model and form (IAN_simple on either wire, the uint8 one through the
`staging` kernel; IANv1 with either head kernel; full IAN with the fused
MDBLOCKs), each group padded to its bucket and run as a captured program,
first held bit for bit against an eager twin on requests of 1 to 20 images
(one capture a bucket), then 64 concurrent 1-image requests per op, a
request split at `max_batch` and an encode/decode burst under the profiler,
each held against `api.IAN` on the card; a `ModelHost` of the three models
over HTTP, whose first calls run at once on three dispatcher threads (their
captures take turns);
the web editor over HTTP held exactly against a direct `EditSession`; and
the serving times, captured beside eager (bench_torch_serving.py's
functions), with each program's first call and each server's peak memory. Then the trainer:
`training.train.train` on IAN_simple at full width (batch 128, the procedural
dataset, two epochs and a resumed third, with the dataset resident on the card
and with per-chunk uploads, each chunk staged by the `staging` kernel, the
steps replayed as captured CUDA graphs), one G and one D step held against
the CPU, the same steps on IANv1 and full IAN, and a chunk of each model
captured held against the same chunk run eagerly;
then (phase 6b) bf16 training: one bf16 G and D step of each model beside
float32 on the same weights and batch (IAN_simple at batch 128 within
npe_tpu's bf16 trajectory bounds; IANv1 and full IAN through the tail's bf16
form alone), `train()` on IAN_simple from a `native:` raw file in bf16 with
encoder-FID validation, a profiler trace and a resumed epoch that reads the
FID basis back, and the sample CLI (the checkpoints' grid, validation and
encoder-FID and the CLI's grid run as captured programs, `training/programs.py`);
then (phase 6c, `[eval]` lines) those programs of each model (IAN_simple,
IANv1 with the hybrid head, full IAN with the per-op MDBLOCKs) at npe_tpu's
shapes, captured against an eager owner bit for bit under deterministic
algorithms, on new inputs and after a second set of weights is loaded, one
capture a signature, the replayed launches held to the profiler's kernels,
and one checkpoint's evaluation timed captured and eager; and the training times, float32 and bf16
in turns, eager and captured (with bench_torch_train.py's function), with
the trainer's three data paths. Then bfloat16: the bf16 forms
of `rgb_beta_tail`, `rgb_beta_head` and `mdblock_fused` and of their backward
kernels held against their bf16 plain versions (and the backwards against the
bf16 VJP), `api.IAN`, `EditSession` and `InferenceServer` (both
wires) with `dtype=torch.bfloat16` on the same weights for every model and
form, held against the card's float32 results within npe_tpu's bf16 bounds,
their launch counts by form, and the bf16 times (kernels, encode+decode at
batch 256 with bench_torch.py's function, strokes with bench_torch_edit.py's).
Last (phase 8), multi-device training over torch.distributed, in subprocesses
with their own time limits: `parallel.multihost`'s G + D step on one rank
over NCCL (IAN_simple, batch 128) and on two ranks sharing the card over gloo
(IAN_simple at 128, IANv1 at 16), each held against the card's one-process
step and timed beside it; from the same two ranks, encode + decode with the
'model' weights in halves held against `api.IAN`; the trainer under torchrun
with `--data-parallel`; and the library blocks (USL, DSL, inception, batch
renorm) against the CPU. The last line is {"ok": true, "device": {...}}; any
failed phase ends the run with a nonzero exit before it. Without a CUDA device
it exits nonzero at once.
"""

import concurrent.futures
import contextlib
import functools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import bench_torch
import bench_torch_edit
from bench_torch_edit import stroke_script

KERNEL_TOL = 1e-5  # kernel vs plain version on the card, max abs
# rgb_beta_head's trunk adds 33 * C = 2112 products per output at C = 64 (its
# four centre taps folded into one; 9 * 16 * C = 9216 in the space-to-depth
# form it replaced) in another order than the plain version's cuDNN conv,
# before the sigmoids and the Beta mean's division.
HEAD_TOL = 5e-5
# mdblock_fused adds up to 9 * 2 * 512 = 9216 products per output in another
# order than the plain version's per-tap cuBLAS products, twice in a row, and
# its check's outputs have a std of 2 to 4 and reach +-25: 1e-5 of the largest.
MDBLOCK_TOL = 2e-4
# x's gradient of mdblock_fused (the backward kernels) against their plain
# version `mdblock_backward_reference` on the kernels' own y and h1: float32
# sums of up to 9216 products in another order, twice in a row, 1e-5 of the
# largest value (as tests/test_torch_cuda.py holds the forward)
MDBLOCK_BWD_TOL = 1e-5
# A slope (lrelu'(a) of a1 or a2) that the kernels read from their own y and
# h1 parts from the plain forward's where the two round a pre-activation to
# opposite sides of zero; such elements are rare (the forward's error is
# about 1e-6 of a pre-activation in float32, 1e-5 in bf16: 3e-5 of a map
# at most on the card, at batch 128 in bf16; a slope read from a wrong layout
# would part at about half), at most this share of a map or MDBLOCK_FLIPS_ANYWAY,
# and the gradient of every pixel within their reach is held to the
# reference alone (`check_mdblock_backward`)
MDBLOCK_FLIP_SHARE, MDBLOCK_FLIPS_ANYWAY = 1e-3, 8
# Card vs CPU: the golden tolerance of the JAX package's tests. The float32
# sums run in other orders on the two devices (TF32 is off).
RTOL, ATOL = 1e-3, 1e-4
UINT8_STEP = 2.0 / 255.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
N_STROKES = bench_torch_edit.N_STROKES
# bfloat16. A bf16 kernel against its bf16 plain version: both round at the
# same points and add in other orders, so at each point that rounds a float32
# sum a hair either side of a boundary may land one bf16 ulp (two of bf16's
# relative steps of 2^-8) away. Each of the three kernels rounds at three
# points (mdblock: each MDCL's input and the output; the tail and the head: R
# and [R, G] before their products, and the output), so each output is held to
# |got - want| <= 3 steps of (|want| + std(want)).
BF16_STEP, BF16_POINTS = 2.0 ** -8, 3
# A bf16 path against the port's float32 path on the same weights: npe_tpu's
# own bounds, mean abs (tests/test_api_bf16.py on images, tests/test_editor.py
# on Z).
IMAGE_BOUND, Z_BOUND = 0.05, 0.2
BF16_TIMED_STROKES = 30
# strokes a profiler window holds: the profiler's own cost, not the strokes',
# is most of phase 7's time, so the window is kept short to leave room for
# the bf16 phases within the run's time
PROFILED_STROKES = 10
TIMED_STROKES = 100
# staging kernel vs plain: x * (2/255) - 1 in float32, rounded alike
STAGING_TOL = 1e-6
# float32 gradients of one step, card vs CPU: a relu that the two devices round
# to opposite sides of zero moves every gradient tensor at once (the
# adversarial gradients are sums of ~1e7 terms of random sign), so they are
# held to 10 % of each tensor's largest value (2.5-2.9 % seen; a missing loss
# term would be tens of percent); the float64 step to GRAD64_TOL.
GRAD32_TOL = 1e-1
GRAD64_TOL = 1e-6
# the captured training chunk against the eager one on the card, from the same
# state, seed and batch: CAPTURE_STEPS steps (an eager G and D, a captured and
# replayed G and D, then replays); in float64 each tensor within CAPTURE64_TOL of
# its largest value (the parity rule: both run the same kernels in the same order)
CAPTURE_STEPS, CAPTURE64_TOL = 6, 1e-7
# phase 7's captured rounds: bench_torch_train.run's G + D pairs a round and rounds
TRAIN_BENCH_PAIRS, TRAIN_BENCH_ROUNDS = 8, 3
# words in the names of cuDNN's convolution kernels (fprop, dgrad, wgrad)
CONV_KERNEL_WORDS = ("conv", "dgrad", "wgrad", "fprop", "implicit_gemm", "xmma", "cudnn")
# a bf16 G + D step against float32 on the same weights and batch: npe_tpu's
# bf16 trajectory bounds (tests/test_training.py:99-140) on (G pixel loss,
# G kl, D discrim loss)
BF16_TRAIN_RTOL, BF16_TRAIN_ATOL = 0.12, 0.02
TRAIN_BATCH, TRAIN_BATCHES_PER_CHUNK = 128, 8
TRAIN_EXAMPLES = 2 * TRAIN_BATCHES_PER_CHUNK * TRAIN_BATCH + TRAIN_BATCH // 2  # two chunks at either offset
# validation images of phase 6b's train(): npe_tpu's FID batch of 256, two batches of 128
FID_EXAMPLES = 256
HEAD_SCALES = [2, 3, 4]
# the tail's backward calls a G + D pair of IANv1 and full IAN: the G step's
# two decodes (the trunk's and the taps' gradients), the D step's
# reconstruction (the latent gradient: the trunk's alone)
TAIL_BWD_PER_PAIR = 3
# serving: requests a phase case sends per op, the max_batch that a 20-image
# request overflows, sequential requests a timed op, concurrent encodes of the
# throughput leg, timed runs a case (their median is reported), and the
# longest any served future or HTTP request may take
SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_TIMED, SERVE_LOAD, SERVE_REPEATS, SERVE_WAIT = 64, 16, 50, 256, 3, 600
# the API scripts: the brush's boxes (moved and resized), the decodes a script
# runs (sample_at twice, a gradient's forward each), the outputs by name, and
# the timed calls a method at batch 1 and at batch 64
API_BOXES = ((8, 8, 24, 24), (20, 30, 36, 50), (0, 40, 12, 64))
API_DECODES = 2 + 2 * len(API_BOXES)
API_GRADIENTS = 2 * len(API_BOXES)  # imgrad and imgradRGB under each box
API_OUTPUTS = ("encode_images b1", "encode_images b64", "sample_at b1", "sample_at b64") + tuple(
    f"{m} box {i}" for i in range(len(API_BOXES)) for m in ("imgrad", "imgradRGB"))
API_TIMED, API_TIMED_B64 = 20, 5
# the served script of the captured-vs-eager checks: one sequential request of
# each size, each its own group: buckets 1, 4, 8, 16, and 20 split into 16 + 4
SERVED_SIZES = (1, 3, 5, 16, 20)
SERVED_BUCKETS = (1, 4, 8, 16)
# the [eval] phase (training/programs.py): the checkpoint grid's programs and
# rows (27 and 21 samples, 6 endpoints), the encoder-FID's batch and images,
# train()'s validation examples, and the checkpoints timed after the first
EVAL_GRID = (("decode_pre_iaf", 27), ("encode_pre_iaf", 6), ("decode_pre_iaf", 21))
EVAL_FID_BATCH, EVAL_FID_IMAGES, EVAL_VALID_EXAMPLES, EVAL_TIMED = 64, 256, 1024, 3
# Full IAN's three MDBLOCKs: (name, channels, map size, scales)
MDBLOCK_SHAPES = (("dec_conv2a", 512, 8, (0, 2)), ("dec_conv3a", 256, 16, (0, 2, 3)),
                  ("dec_conv4a", 128, 32, (0, 2, 3)))


def log(*args):
    print(*args, flush=True)


class Counts:
    """The kernels' launch counts by form: name -> (wrapper, attribute); a
    wrapper counts its float32 form's launches in `launches` and its bf16
    form's in `launches_bf16` (its backward kernels, the MDBLOCK's, the
    tail's and the head's, in `launches_bwd` and `launches_bwd_bf16`)."""

    def __init__(self, forms):
        self.forms = forms

    def zero(self):
        for fn, attr in self.forms.values():
            setattr(fn, attr, 0)

    def read(self):
        return {name: getattr(fn, attr) for name, (fn, attr) in self.forms.items()}


# the port's kernels by name, as torch.profiler records them on the card:
# name -> (the `Counts` name of its float32 form, of its bf16 form, kernels of
# that name a wrapper launch runs). A wrapper launch runs its named kernel
# once (the float32 MDBLOCK runs mdcl_kernel three times, its prologue and
# one an MDCL, their arguments opening with `float const*`, which the bf16
# form's mdcl_kernel does not; the MDBLOCK backward's first launch forms
# g_r: bwd_prologue_kernel in float32, bwd_prologue_bf16_kernel in bf16;
# the tail's backward opens with
# tail_bwd_green_kernel, the head's x-gradient ends with
# head_trunk_bwd_kernel); the head's own tail (rgb_beta_tail_kernel<..., true>)
# and its own tail backward (tail_bwd_*_kernel<..., true>), the slice sums, the
# tail backward's other passes and the MDBLOCK backward's mdcl_bwd_kernel are
# left out.
DEVICE_KERNELS = {"edit_tail_kernel": ("edit_tail", None, 1),
                  "rgb_beta_tail_kernel": ("rgb_beta_tail", "rgb_beta_tail_bf16", 1),
                  "head_trunk_kernel": ("rgb_beta_head", "rgb_beta_head_bf16", 1),
                  "tail_bwd_green_kernel": ("rgb_beta_tail_bwd", "rgb_beta_tail_bwd_bf16", 1),
                  "head_trunk_bwd_kernel": ("rgb_beta_head_bwd", "rgb_beta_head_bwd_bf16", 1),
                  "mdcl_kernel": ("mdblock", None, 3), "prologue_kernel": (None, "mdblock_bf16", 1),
                  "bwd_prologue_kernel": ("mdblock_bwd", None, 1),
                  "bwd_prologue_bf16_kernel": (None, "mdblock_bwd_bf16", 1),
                  "stage_kernel": ("staging", None, 1)}


def witnessed(kernels):
    """The wrappers' launches that the device kernels in `kernels` ({the
    profiler's kernel name: executions}) witness, by `Counts` name; a
    kernel's template arguments give its form."""
    out = {}
    for name, n in kernels.items():
        sig, _, args = name.removeprefix("void ").replace("(anonymous namespace)::", "").partition("(")
        base = sig.removeprefix("npe::").split("<", 1)[0]
        if base not in DEVICE_KERNELS or sig.endswith("true>") or \
                (base == "mdcl_kernel" and not args.startswith("float const*")):
            continue
        f32, bf16, per_launch = DEVICE_KERNELS[base]
        counter = bf16 if "bfloat16" in sig or f32 is None else f32
        out[counter] = out.get(counter, 0) + n / per_launch
    return out


def profiled(fn):
    """fn() under torch.profiler, the card synchronised after it: (its
    result, `witnessed` of the device kernels the profiler recorded). The
    recorded kernels by name are kept in LAST_PROFILE for a failure's
    message. The first few device records of a window can be missing from
    the profiler's results: late in this script a served script's first
    upload, and then its first staging kernel, were (the kernel ran: the
    results were exact; one run in two). So each window opens with
    PROFILER_LEAD small kernels of its own, which count for nothing, and
    waits for them."""
    from torch.autograd import DeviceType

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        lead = torch.zeros(PROFILER_LEAD, device="cuda")
        for i in range(PROFILER_LEAD):
            lead[i:i + 1].add_(1)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    LAST_PROFILE.clear()
    LAST_PROFILE.update({e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA})
    return out, witnessed(LAST_PROFILE)


LAST_PROFILE = {}
PROFILER_LEAD = 16


def check_witnessed(label, launches, seen):
    """The wrappers' counts of a run against the device kernels the profiler
    recorded in it: a replay counts what its capture recorded, and this holds
    that count to the kernels the card ran."""
    counted = {name: n for name, n in launches.items() if n}
    if seen != counted:
        log(f"  [main] {label}: the profiler recorded, by kernel name: {json.dumps(LAST_PROFILE)}")
    assert seen == counted, f"{label}: the card ran {seen}, the wrappers counted {counted}"
    log(f"  [main] {label}: the device kernels the profiler recorded match the wrappers' counts {counted}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def check_close(name, a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=name)
    log(f"  {name}: max abs diff {max_err(a, b):.3e} (rtol {rtol}, atol {atol})")


def check_recon_close(name, a, b):
    """uint8 RECON truncation turns a tiny difference at a quantization
    boundary into one uint8 step: all values within ATOL except at most
    0.1% that differ by exactly one step."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    off = d > ATOL
    assert off.mean() <= 1e-3, f"{name}: {off.sum()} of {d.size} values differ"
    np.testing.assert_allclose(d[off], UINT8_STEP, atol=ATOL, err_msg=name)
    log(f"  {name}: {off.sum()} of {d.size} values one uint8 step apart, the rest within {ATOL}")


def check_im_close(name, a, b, recon_a, recon_b):
    """IM = mask*xh + (1-mask)*x sees RECON only through the mask (blur
    radius 3): within 3 pixels of a RECON value one step apart, IM may move
    by up to step/3 * 2; elsewhere the usual tolerance holds."""
    near = np.abs(np.asarray(recon_a) - np.asarray(recon_b)).max(axis=0) > ATOL
    padded = np.pad(near, 3)
    h, w = near.shape
    near = np.zeros_like(near)
    for dy in range(7):
        for dx in range(7):
            near |= padded[dy:dy + h, dx:dx + w]
    np.testing.assert_allclose(a[:, ~near], b[:, ~near], rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(a[:, near], b[:, near], atol=UINT8_STEP / 3 * 2, err_msg=name)
    log(f"  {name}: max abs diff {max_err(a, b):.3e}; {near.sum()} pixels near a RECON step")


def edit_tail_inputs(batch, mask_kind, seed, device):
    rng = np.random.RandomState(seed)
    xh = rng.rand(batch, 64, 64, 3).astype(np.float32) * 2 - 1
    recon = rng.rand(batch, 64, 64, 3).astype(np.float32) * 2 - 1
    err = rng.rand(batch, 64, 64, 3).astype(np.float32) * 0.2
    um = {
        None: None,
        "zeros": np.zeros((batch, 64, 64), np.float32),
        "random": rng.rand(batch, 64, 64).astype(np.float32) * 0.5,
        "ones": np.ones((batch, 64, 64), np.float32),
    }[mask_kind]
    return [None if a is None else torch.from_numpy(a).to(device) for a in (xh, recon, err, um)]


def edit_tail_bound_ms(batch, n, radius):
    """Least time for edit_tail on this card: each input read once, the
    output written once, over HBM bandwidth; or its float32 operations over
    the float32 rate, whichever is larger."""
    px = batch * n * n
    nbytes = 4 * (3 * px * 3 + px + px * 3 + 2 * radius + 1)
    # per pixel: |DELTA| mean and min (10), two blur passes (2 * 2 * taps),
    # floor and clip (3), composite (6 per channel)
    ops = px * (10 + 4 * (2 * radius + 1) + 3 + 18)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def head_inputs(batch, channels, seed, device):
    """Seeded O(1) decoder features and trunk pre-activations, the trunk's
    stacked taps for HEAD_SCALES (36 taps, 33 distinct offsets) and the
    tail's tap matrices at unit gain (a tail pre-activation sums 9 * in
    products, of which a 9x9 composed kernel at r = 4 fills about a
    quarter)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, channels, 64, 64).astype(np.float32)
    tr = (rng.randn(36, channels, 6) / np.sqrt(33 * channels)).astype(np.float32)
    trunk = rng.randn(batch, 96, 16, 16).astype(np.float32)
    tg = (rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)
    tb = (rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, tr, trunk, tg, tb)]


def mdblock_inputs(batch, channels, size, scales, seed, device):
    """Seeded O(1) features, two tap tensors at unit gain (a composed MDCL
    kernel carries about 2.2 taps' worth of variance per input channel) and
    non-trivial affines."""
    rng = np.random.RandomState(seed)
    n_taps = 9 * (1 + sum(s > 0 for s in scales))
    x = rng.randn(batch, channels, size, size).astype(np.float32)
    taps = [(rng.randn(n_taps, channels, channels) / np.sqrt(2.2 * channels)).astype(np.float32)
            for _ in range(2)]
    aff = np.stack([rng.uniform(0.8, 1.2, channels), rng.uniform(-0.2, 0.2, channels)] * 3).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, *taps, aff)]


def mdblock_bound_ms(batch, channels, size, scales, route="3xtf32", backward=False):
    """Least time for one MDBLOCK: x and both tap tensors and the affines
    read once, the output written once; two MDCLs of H*W*T*C^2 multiply-adds,
    and about ten float32 operations per element for the three affines,
    lrelus and the residual. route "3xtf32", the float32 kernel's: each
    multiply-add is three TF32 products on the tensor cores (two operations
    each); "fp32": one float32 multiply-add outside them; "bf16", the bf16
    form's: x, the taps and the output 2 bytes an element, one bf16 product.
    `backward`: x's gradient, the same multiply-adds (MDCL2^T, MDCL1^T); g,
    x, y and h1 read once, dx written once, about twelve elementwise
    operations per element (three slopes, three scales, g_r twice, the sum)."""
    n_taps = 9 * (1 + sum(s > 0 for s in scales))
    px = batch * size * size
    elt = 2 if route == "bf16" else 4
    maps = 5 if backward else 2
    nbytes = elt * (maps * px * channels + 2 * n_taps * channels * channels) + 4 * 6 * channels
    macs = 2 * px * n_taps * channels * channels
    other = (12 if backward else 10) * px * channels
    if route != "3xtf32":
        return kernel_bound_ms(nbytes, 2 * macs, other, "bfloat16" if route == "bf16" else "float32")
    # the elementwise operations in TF32-rate units, so that one peak divides both
    return roofline_ms(nbytes, 3 * 2 * macs + other * TF32_OPS_PER_S / FP32_OPS_PER_S, TF32_OPS_PER_S)


def time_mdblock_backward(variables, name, channels, size, scales, batch, seed, smi, dtype=torch.float32):
    """x's gradient of one MDBLOCK as device time (CUDA graph): the backward
    kernels alone (on the y and h1 a forward kept), the plain version's VJP
    as the backward ran it before the kernels (the plain forward again, then
    its VJP), and the yardstick, the per-op block's backward from the
    weights (`variables`, the block `name`; cuDNN and cuBLAS): its forward
    and backward under autograd less its forward alone (a graph captures
    the backward on the stream of its forward, so both are captured); the
    fused form's forward and backward under autograd beside it; the
    backward's bound. Returns {"ms", "plain_ms", "per_op_ms", "fused_fwd_bwd_ms",
    "per_op_fwd_bwd_ms", "bound_ms", "bound_by", "launches_per_call"}."""
    from npe_tpu_torch.models import common
    from npe_tpu_torch.ops.kernels import mdblock as mk
    from npe_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda")
    x, t1, t2, aff = mdblock_inputs(batch, channels, size, scales, seed, dev)
    bf16 = dtype == torch.bfloat16
    x, t1, t2 = (t.to(dtype) for t in (x, t1, t2))
    g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev).to(dtype)
    xg = x.clone().requires_grad_(True)
    out = mk.mdblock_fused(xg, t1, t2, aff, scales)  # kept alive: y is one of its saved tensors
    h1, y = out.grad_fn.saved_tensors[4:]
    assert mk._launch_bwd(g, x, y, h1, t1, t2, aff, scales)[1] == 0
    reps = dict(iters=5, reps=4) if batch == 128 else dict(iters=20)
    k_ms = graph_ms(lambda: mk._launch_bwd(g, x, y, h1, t1, t2, aff, scales), **reps)
    plain = functools.partial(mk.mdblock_taps_reference, scales=scales)
    p_ms = graph_ms(lambda: mk.vjp_of_plain(plain, (True, False, False, False), (x, t1, t2, aff), g), **reps)
    def block(h):
        return common.mdblock(variables, None, name, h, scales, common.LRELU, False, mode="plain")

    def forward_backward(fn):
        """fn's forward and x's gradient; the leaf is made inside, so that a
        capture holds its whole graph (a leaf made outside ties the backward
        to the stream it was made on)."""
        def run():
            leaf = x.detach().requires_grad_(True)
            return torch.autograd.grad(fn(leaf), leaf, g)
        return run

    fb_ms = graph_ms(forward_backward(lambda h: mk.mdblock_fused(h, t1, t2, aff, scales)), **reps)
    o_fb_ms = graph_ms(forward_backward(block), **reps)
    with torch.no_grad():
        o_f_ms = graph_ms(lambda: block(x), **reps)
    bound = mdblock_bound_ms(batch, channels, size, scales, "bf16" if bf16 else "3xtf32", backward=True)
    plan = mk.bwd_plan(*x.shape, scales, dtype, torch.cuda.get_device_properties(dev).multi_processor_count)
    log(f"[time] mdblock_bwd{'_bf16' if bf16 else ''} {size}x{size}x{channels} batch {batch}, x's gradient, device "
        f"time (CUDA graph): kernels {k_ms:.5f} ms ({mk.bwd_launches(plan)} launches, {plan}), plain VJP (forward "
        f"again, then its VJP) {p_ms:.5f} ms, the "
        f"per-op block's backward from the weights {o_fb_ms - o_f_ms:.5f} ms (forward and backward {o_fb_ms:.5f}, "
        f"forward {o_f_ms:.5f}), the fused block's forward and backward {fb_ms:.5f} ms, bound {bound[0]:.6f} ms "
        f"({bound[1]}) ({smi})")
    return {"ms": k_ms, "plain_ms": p_ms, "per_op_ms": o_fb_ms - o_f_ms, "fused_fwd_bwd_ms": fb_ms,
            "per_op_fwd_bwd_ms": o_fb_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "launches_per_call": mk.bwd_launches(plan)}


def mdblock_backward_entry(name, source, times):
    """The `kernels` entry of a backward form from its batch-1 times
    (`time_mdblock_backward`) at full IAN's three shapes: one stroke's
    gradient runs each once, so the entry is their sum; no single library
    call computes the block's gradient (the per-op one is a composition)."""
    from npe_tpu_torch.ops.kernels import mdblock as mk

    per_shape = [dict(t, shape=shape) for (shape, batch), t in times.items() if batch == 1]
    return {"name": name, "source": source, "replaces": mk.REPLACES_BWD,
            **{key: sum(e[key] for e in per_shape) for key in ("ms", "plain_ms", "bound_ms", "per_op_ms")},
            "bound_by": max(per_shape, key=lambda e: e["bound_ms"])["bound_by"], "per_shape": per_shape}


def slope_flips(x, taps1, taps2, affines, scales, y, h1):
    """Where the slopes the backward kernels read from their own y and h1
    part from the plain forward's (an a1 or a2 that the two round to opposite
    sides of zero): (flipped a1, flipped a2, the (N, C, H, W) mask of every
    element within the flipped a1s' reach: dx at a pixel depends on a1 within
    one MDCL's radius R of it, through MDCL1^T, over every channel). A
    flipped a2 changes g_r = s2 lrelu'(a2) g by 0.8 s2 g at its element;
    under the cotangent of sum(y^2), g = 2 y, and y is within the forward's
    error of zero there, so it changes dx by as little and is left in."""
    from npe_tpu_torch.ops.kernels import mdblock as mk

    y_plain, h1_plain = mk.mdblock_forward_parts(x, taps1, taps2, affines, scales)
    f1, f2 = (h1 > 0) != (h1_plain > 0), (y > 0) != (y_plain > 0)
    r = max(mk.dilations(scales))
    near = F.max_pool2d(f1.any(1, keepdim=True).float(), 2 * r + 1, 1, r) > 0
    return int(f1.sum()), int(f2.sum()), near.expand_as(x)


def check_mdblock_backward(label, x, taps1, taps2, affines, scales):
    """x's gradient of sum(out^2) through mdblock_fused, the backward kernels
    (`launches_bwd` / `launches_bwd_bf16` count one), held to
    `mdblock_backward_reference` on the same cotangent and the kernels' own y
    and h1 (kept by the forward) on every element: float32 within
    MDBLOCK_BWD_TOL of the largest value, bf16 within BF16_POINTS + 1 steps
    (the same rounding points, sums in another order); and to the plain
    version's VJP on every element outside the reach of a slope of a1 that
    parts from the plain forward's (`slope_flips`, each kind at most
    MDBLOCK_FLIP_SHARE of the map or MDBLOCK_FLIPS_ANYWAY) by the rules the
    VJP was held to when it was the backward: float32 at RTOL and ATOL of
    the largest value, bf16 within BF16_POINTS + 1 steps (the VJP's three
    rounding points, each MDCL^T's sum and dx, and one for a gradient; the
    kernels feed the float32 g_r and g_m1 to wgmma as bf16 pairs, which add
    none). Two more calls on the same inputs are bit-equal to autograd's.
    The label names `bwd_plan`'s cut. Returns the largest difference from
    the reference."""
    from npe_tpu_torch.ops.kernels import mdblock as mk

    bf16 = x.dtype == torch.bfloat16
    plan = mk.bwd_plan(*x.shape, scales, x.dtype, torch.cuda.get_device_properties(x.device).multi_processor_count)
    label = f"{label} (backward {plan})"
    attr = "launches_bwd_bf16" if bf16 else "launches_bwd"
    xg = x.clone().requires_grad_(True)
    out = mk.mdblock_fused(xg, taps1, taps2, affines, scales)
    kept = out.grad_fn.saved_tensors
    assert len(kept) == 6, f"{label}: the forward kept {len(kept)} tensors, not x, the taps, the affines, h1, y"
    h1, y = (kept[4].permute(0, 3, 1, 2) if bf16 else kept[4]), kept[5]
    before = getattr(mk.mdblock_fused, attr)
    (got,) = torch.autograd.grad((out.float() ** 2).sum(), xg)
    torch.cuda.synchronize()
    assert getattr(mk.mdblock_fused, attr) == before + 1, f"{label}: the backward kernels did not launch once"
    g = (2 * out.detach().float()).to(x.dtype)  # the cotangent autograd gave the backward
    # two more calls on the same inputs (not counted): bit-equal to autograd's (fixed-order sums, no atomics)
    again = [mk._launch_bwd(g, x, y, kept[4], taps1, taps2, affines, scales) for _ in range(2)]
    assert all(rc == 0 and torch.equal(dx, got) for dx, rc in again), f"{label}: two calls are not bit-equal"
    ref = mk.mdblock_backward_reference(g, x, y, h1, taps1, taps2, affines, scales)
    xp = x.clone().requires_grad_(True)
    (vjp,) = torch.autograd.grad((mk.mdblock_taps_reference(xp, taps1, taps2, affines, scales).float() ** 2).sum(),
                                 xp)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype and bool(torch.isfinite(got).all()), label
    e = float((got.double() - ref.double()).abs().max())
    if bf16:
        within_steps(f"[kernel] {label} x's gradient vs mdblock_backward_reference", got, ref, BF16_POINTS + 1)
    else:
        tol = MDBLOCK_BWD_TOL * float(ref.abs().max())
        log(f"[kernel] {label} x's gradient vs mdblock_backward_reference: max abs err {e:.3e} (tol {tol:.3e}, "
            f"{MDBLOCK_BWD_TOL} of the largest)")
        assert e <= tol, f"{label}: x's gradient disagrees with mdblock_backward_reference: {e}"
    flips1, flips2, near = slope_flips(x, taps1, taps2, affines, scales, y, h1)
    assert max(flips1, flips2) <= max(MDBLOCK_FLIPS_ANYWAY, MDBLOCK_FLIP_SHARE * x.numel()), (
        f"{label}: slopes part at {flips1}, {flips2}")
    far = ~near
    what = (f"x's gradient vs the plain VJP outside the reach of the slopes of a1 that part from the plain "
            f"forward's ({flips1}; {int(near.sum())} of {x.numel()} elements within reach; {flips2} of a2, under "
            f"this cotangent at y within the forward's error of zero, left in)")
    if bf16:
        within_steps(f"[kernel] {label} {what}", got[far], vjp[far], BF16_POINTS + 1)
    else:
        g_far, v_far = got[far].cpu().numpy(), vjp[far].cpu().numpy()
        np.testing.assert_allclose(g_far, v_far, rtol=RTOL, atol=ATOL * float(vjp.abs().max()),
                                   err_msg=f"{label} x's gradient vs the plain VJP")
        log(f"[kernel] {label} {what}: max abs diff {max_err(g_far, v_far):.3e} within rtol {RTOL}, atol {ATOL} "
            f"of the largest")
    return e


def within_steps(label, got, want, points=BF16_POINTS):
    """Hold bf16 `got` to `want` (same shape, both bf16) within `points` of
    bf16's relative steps of |want| + std(want), element by element. Returns
    the largest difference."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, (got.dtype, want.dtype)
    g, w = got.double(), want.double()
    err = (g - w).abs()
    limit = points * BF16_STEP * (w.abs() + w.std())
    worst = float((err / limit).max())
    log(f"  {label}: max abs diff {float(err.max()):.3e}, mean {float(err.mean()):.3e}; worst {worst:.3f} of "
        f"{points} bf16 steps of |want| + std {float(w.std()):.3f}")
    assert worst <= 1.0, f"{label}: {int((err > limit).sum())} values beyond {points} bf16 steps"
    return float(err.max())


def mean_close(label, got, want, bound):
    """A bf16 path's float32 output against the float32 path's: mean abs
    within npe_tpu's bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), label
    gap = float(np.abs(got - want).mean())
    log(f"  {label}: mean abs diff {gap:.4e} (bound {bound}), max {float(np.abs(got - want).max()):.3e}")
    assert gap < bound, f"{label}: mean abs diff {gap} over {bound}"


def roofline_ms(nbytes, flops, peak=FP32_OPS_PER_S):
    """The larger of the bytes over HBM bandwidth and the operations over
    `peak`, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_bound_ms(nbytes, products, other, dtype):
    """roofline_ms of a kernel's bytes, its multiply-adds' operations
    (`products`) and its elementwise float32 operations (`other`): in float32
    all of them at the float32 rate; in bfloat16 the products at the tensor
    cores' bf16 rate and the rest at the float32 rate, in bf16-rate units."""
    if dtype == "bfloat16":
        return roofline_ms(nbytes, products + other * BF16_OPS_PER_S / FP32_OPS_PER_S, BF16_OPS_PER_S)
    return roofline_ms(nbytes, products + other)


def tail_work(batch, cells=256, rr=16, elt=4, trunk_elt=None):
    """(bytes, multiply-add operations, other operations) of the
    autoregressive tail: the G_b (2rr -> 2rr) and B_b (4rr -> 2rr) tap
    products at two operations a multiply-add, and about ten operations for
    each sigmoid and Beta mean; `elt` bytes an element of the taps and the
    output, `trunk_elt` (default `elt`) of the trunk."""
    nbytes = (batch * 6 * rr * cells * (trunk_elt or elt)
              + elt * (9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr + batch * 3 * rr * cells))
    return nbytes, batch * cells * 2 * 9 * (2 * rr * 2 * rr + 4 * rr * 2 * rr), batch * cells * 10 * 9 * rr


def rgb_beta_tail_bound_ms(batch, dtype="float32", trunk_elt=None):
    """Least time for rgb_beta_tail on this card: trunk and taps read once,
    the output written once, or its operations, whichever is larger; in
    bfloat16 2 bytes an element (the trunk `trunk_elt`: 4 for a float32 one)."""
    return kernel_bound_ms(*tail_work(batch, elt=2 if dtype == "bfloat16" else 4, trunk_elt=trunk_elt), dtype)


def rgb_beta_head_bound_ms(batch, channels, cells=256, rr=16, offsets=33, dtype="float32"):
    """Least time for rgb_beta_head: x and the three tap tensors it is given
    read once, the image written once; the work the function needs, each
    output pixel's MDCLs over their 33 distinct offsets (the trunk C -> 6,
    the tail's G_b 2 -> 2 and B_b 4 -> 2), two operations a multiply-add,
    and about ten operations for each sigmoid and Beta mean; in bfloat16 2
    bytes an element."""
    px = batch * cells * rr
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (px * channels + 36 * channels * 6 + 9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr + px * 3)
    products = px * 2 * offsets * (channels * 6 + 2 * 2 + 4 * 2)
    return kernel_bound_ms(nbytes, products, batch * cells * 10 * 9 * rr, dtype)


def rgb_beta_tail_bwd_bound_ms(batch, need_taps=True, dtype="float32", trunk_elt=None, cells=256, rr=16):
    """Least time for the tail's backward: the cotangent, the trunk and the
    taps read once, the trunk's gradient (and with `need_taps` the taps')
    written once; the work, in multiply-adds a cell: the forward again (G_b
    2rr -> 2rr, B_b 4rr -> 2rr over 9 taps), B^T and G^T (the same counts),
    and with the taps their gradients (the same counts again), two
    operations each, and about 30 operations for each element's sigmoid,
    Beta-mean derivative and sigmoid derivative; `elt` bytes as
    `rgb_beta_tail_bound_ms`."""
    elt = 2 if dtype == "bfloat16" else 4
    taps = 9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr
    nbytes = (batch * cells * (3 * rr * elt + 2 * 6 * rr * (trunk_elt or elt))
              + elt * taps * (2 if need_taps else 1))
    products = batch * cells * 2 * taps * (3 if need_taps else 2)
    return kernel_bound_ms(nbytes, products, batch * cells * 30 * 6 * rr, dtype)


def rgb_beta_head_bwd_bound_ms(batch, channels, cells=256, rr=16, offsets=33, dtype="float32"):
    """Least time for x's gradient of the head: the image's cotangent, the
    forward's float32 trunk, x's three tap tensors read once, dx written
    once; the tail's backward for the trunk alone (`rgb_beta_tail_bwd_bound_ms`'s
    work) and the trunk's transposed conv, 6 * C multiply-adds a pixel over
    the 33 distinct offsets."""
    px = batch * cells * rr
    elt = 2 if dtype == "bfloat16" else 4
    taps = 9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr
    nbytes = px * (3 * elt + 6 * 4 + channels * elt) + elt * (36 * channels * 6 + taps)
    products = batch * cells * 2 * taps * 2 + px * 2 * offsets * channels * 6
    return kernel_bound_ms(nbytes, products, batch * cells * 30 * 6 * rr, dtype)


def tail_bwd_inputs(batch, seed, dev, dtype=torch.float32, trunk_dtype=None):
    """head_inputs' trunk and tail taps in `dtype` (the trunk in
    `trunk_dtype`, default `dtype`) and a seeded cotangent of the output."""
    rng = np.random.RandomState(seed)
    trunk = torch.from_numpy(rng.randn(batch, 96, 16, 16).astype(np.float32)).to(dev, trunk_dtype or dtype)
    tg = torch.from_numpy((rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)).to(dev, dtype)
    tb = torch.from_numpy((rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(batch, 48, 16, 16).astype(np.float32)).to(dev, dtype)
    return trunk, tg, tb, g


def check_backward(label, got, want, vjp):
    """A backward kernel's gradient against its plain version and the plain
    forward's VJP: float32 within RTOL and ATOL of the largest value; bf16
    within BF16_POINTS + 1 steps of each (a float32 result, the trunk's
    gradient under the fused head, compared in bf16). Returns the largest
    difference from the plain version."""
    assert got.shape == want.shape and got.dtype == want.dtype and bool(torch.isfinite(got).all()), label
    e = float((got.double() - want.double()).abs().max())
    if want.dtype == torch.bfloat16 or "bf16" in label:
        for what, ref in (("its plain version", want), ("the bf16 VJP", vjp)):
            within_steps(f"[kernel] {label} vs {what}", got.to(torch.bfloat16), ref.to(torch.bfloat16),
                         BF16_POINTS + 1)
        return e
    for what, ref in (("its plain version", want), ("the plain VJP", vjp)):
        a, b = got.cpu().numpy(), ref.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * float(np.abs(b).max()), err_msg=f"{label} vs {what}")
        log(f"[kernel] {label} vs {what}: max abs diff {max_err(a, b):.3e} within rtol {RTOL}, atol {ATOL} of the "
            f"largest ({float(np.abs(b).max()):.3e})")
    return e


def check_tail_backward(batch, seed, dev, dtype=torch.float32, trunk_dtype=None):
    """The tail's backward kernels (`_launch_bwd`, not counted) for dtrunk,
    dtg and dtb against `rgb_beta_tail_backward_reference` and the plain
    forward's VJP on the same inputs (`check_backward`); the trunk's
    gradient alone equal to the whole call's, and a second call bit-equal
    (the taps' partial sums added in a fixed order). Returns the largest
    difference from the plain version."""
    from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt

    trunk, tg, tb, g = tail_bwd_inputs(batch, seed, dev, dtype, trunk_dtype)
    got = rt._launch_bwd(g, trunk, tg, tb)
    torch.cuda.synchronize()
    want = rt.rgb_beta_tail_backward_reference(g, trunk, tg, tb)
    leaves = [t.clone().requires_grad_(True) for t in (trunk, tg, tb)]
    vjp = torch.autograd.grad(rt.rgb_beta_tail_reference(*leaves), leaves, g)
    form = "rgb_beta_tail_bwd" + ("_bf16" if dtype == torch.bfloat16 else "")
    trunk_note = f", {str(trunk.dtype).split('.')[1]} trunk" if dtype == torch.bfloat16 else ""
    worst = max(check_backward(f"{form} batch {batch}{trunk_note} {name}", a, b, v)
                for name, a, b, v in zip(("dtrunk", "dtg", "dtb"), got, want, vjp))
    again = rt._launch_bwd(g, trunk, tg, tb)
    alone = rt._launch_bwd(g, trunk, tg, tb, need_taps=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, got)), f"{form} batch {batch}: two calls differ"
    assert alone[1:] == (None, None) and torch.equal(alone[0], got[0]), f"{form} batch {batch}: the trunk's alone"
    log(f"[kernel] {form} batch {batch}{trunk_note}: two calls bit-equal; the trunk's gradient alone equal to the "
        "whole call's")
    return worst


def check_head_backward(batch, channels, seed, dev, dtype=torch.float32):
    """x's gradient through rgb_beta_head's backward kernels (one call
    counted in `launches_bwd` / `launches_bwd_bf16`) against
    `rgb_beta_head_backward_reference` on the forward's own float32 trunk and
    against the plain forward's VJP (`check_backward`). Returns the largest
    difference from the plain version."""
    from npe_tpu_torch.ops.kernels import rgb_beta_head as rh

    x, tr, _, tg, tb = (t.to(dtype) for t in head_inputs(batch, channels, seed, dev))
    g = torch.randn((batch, 3, 64, 64), generator=torch.Generator(device=dev).manual_seed(seed), device=dev).to(dtype)
    xg = x.clone().requires_grad_(True)
    out = rh.rgb_beta_head(xg, tr, tg, tb, HEAD_SCALES)
    trunk = out.grad_fn.saved_tensors[4]
    attr = "launches_bwd_bf16" if dtype == torch.bfloat16 else "launches_bwd"
    before = getattr(rh.rgb_beta_head, attr)
    (got,) = torch.autograd.grad(out, xg, g)
    torch.cuda.synchronize()
    assert getattr(rh.rgb_beta_head, attr) == before + 1 and trunk.dtype == torch.float32
    want = rh.rgb_beta_head_backward_reference(g, trunk, tr, tg, tb, HEAD_SCALES)
    xp = x.clone().requires_grad_(True)
    (vjp,) = torch.autograd.grad(rh.rgb_beta_head_reference(xp, tr, tg, tb, HEAD_SCALES), xp, g)
    form = "rgb_beta_head_bwd" + ("_bf16" if dtype == torch.bfloat16 else "")
    return check_backward(f"{form} C {channels} batch {batch} x's gradient", got, want, vjp)


def time_tail_backward(batch, dtype, need_taps, smi, trunk_dtype=None, seed=130):
    """The tail's backward as device time (CUDA graph): the kernels
    (`_launch_bwd`), the plain version's VJP as the backward ran before them
    (the plain forward again, then its VJP) for the same gradients, and the
    bound. No single library call computes it."""
    from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
    from npe_tpu_torch.utils.timing import graph_ms

    trunk, tg, tb, g = tail_bwd_inputs(batch, seed, torch.device("cuda"), dtype, trunk_dtype)
    reps = dict(iters=10, reps=3) if batch == 128 else dict(iters=20)
    k_ms = graph_ms(lambda: rt._launch_bwd(g, trunk, tg, tb, need_taps=need_taps), **reps)
    p_ms = graph_ms(lambda: rt.vjp_of_plain(rt.rgb_beta_tail_reference, (True, need_taps, need_taps),
                                            (trunk, tg, tb), g), **reps)
    bf16 = dtype == torch.bfloat16
    bound = rgb_beta_tail_bwd_bound_ms(batch, need_taps, "bfloat16" if bf16 else "float32",
                                       trunk_elt=trunk.element_size())
    what = ("the trunk's and the taps' gradients" if need_taps else "the trunk's gradient alone") + (
        f", {str(trunk.dtype).split('.')[1]} trunk" if bf16 else "")
    log(f"[time] rgb_beta_tail_bwd{'_bf16' if bf16 else ''} batch {batch}, {what}, device time (CUDA graph): kernels "
        f"{k_ms:.5f} ms, plain VJP (the plain forward again, then its VJP) {p_ms:.5f} ms, bound {bound[0]:.6f} ms "
        f"({bound[1]}) ({smi})")
    return {"batch": batch, "taps": need_taps, "trunk": str(trunk.dtype).split(".")[1], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


def time_head_backward(batch, channels, dtype, smi, seed=140):
    """x's gradient of the head as device time (CUDA graph): the kernels
    (`_launch_bwd` on a forward's trunk), the plain version's VJP as the
    backward ran before them (the plain head again, then its VJP for x), and
    the library yardstick, one cuDNN call of the trunk conv's x-gradient
    (`torch.nn.grad.conv2d_input` of the unpacked trunk gradient with the
    9x9 `trunk_kernel`, TF32 off; it leaves out the tail's backward), and the
    bound."""
    from npe_tpu_torch.ops.kernels import rgb_beta_head as rh
    from npe_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda")
    x, tr, _, tg, tb = (t.to(dtype) for t in head_inputs(batch, channels, seed, dev))
    g = torch.randn((batch, 3, 64, 64), generator=torch.Generator(device=dev).manual_seed(seed), device=dev).to(dtype)
    _, trunk = rh._launch(x, tr, tg, tb, HEAD_SCALES)
    k = rh.trunk_kernel(tr, HEAD_SCALES)
    d6 = F.pixel_shuffle(torch.randn_like(trunk), 4).to(dtype)
    reps = dict(iters=20)
    k_ms = graph_ms(lambda: rh._launch_bwd(g, x, trunk, tr, tg, tb, HEAD_SCALES), **reps)
    plain = functools.partial(rh.rgb_beta_head_reference, scales=HEAD_SCALES)
    p_ms = graph_ms(lambda: rh.vjp_of_plain(plain, (True, False, False, False), (x, tr, tg, tb), g), **reps)
    lib_ms = graph_ms(lambda: torch.nn.grad.conv2d_input(x.shape, k, d6, padding=k.shape[-1] // 2), **reps)
    bf16 = dtype == torch.bfloat16
    bound = rgb_beta_head_bwd_bound_ms(batch, channels, dtype="bfloat16" if bf16 else "float32")
    log(f"[time] rgb_beta_head_bwd{'_bf16' if bf16 else ''} C {channels} batch {batch}, x's gradient, device time "
        f"(CUDA graph): kernels {k_ms:.5f} ms, plain VJP (the plain head again, then its VJP) {p_ms:.5f} ms, the "
        f"library's trunk-conv x-gradient alone (conv2d_input) {lib_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}) "
        f"({smi})")
    return {"batch": batch, "channels": channels, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


def backward_entry(name, source, replaces, cases):
    """The `kernels` entry of a backward form: its first case's numbers
    (the edit path's call: batch 1, the trunk's or x's gradient alone), the
    others under `per_case`."""
    first = cases[0]
    return {"name": name, "source": source, "replaces": replaces,
            **{key: first[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": first.get("library_ms"), "per_case": cases}


def rgb_beta_head_s2d_bound_ms(batch, channels, cells=256, rr=16):
    """The bound of the space-to-depth form the kernel had before its
    direct trunk: the trunk's 9 * 16C * 96 multiply-adds per cell
    (structural zeros included) on top of the tail's s2d operations, and its
    3.5 MB tap tensor. Kept beside `rgb_beta_head_bound_ms`, the work the
    function needs, so that older measurements stay comparable."""
    tail_bytes, tail_products, tail_other = tail_work(batch)
    tail_bytes -= 4 * batch * 6 * rr * cells  # the trunk never leaves the kernel
    nbytes = tail_bytes + 4 * (batch * channels * rr * cells + 9 * rr * channels * 6 * rr)
    flops = tail_products + tail_other + batch * cells * 2 * 9 * rr * channels * 6 * rr
    return roofline_ms(nbytes, flops)


def run_session_script(session, image, z_grid, n_strokes=N_STROKES, tail=True):
    """The main path. Returns the number of paint and composite steps it
    took (each stroke and set_latents: edit_tail runs on every one, as it does
    in npe_tpu's `_paint_step` and `_composite_step`, whether the session
    shows a sample or not; scroll_patch never runs it), the number of decodes
    (infer, set_latents and sample one each, a stroke or a scroll two: one
    under the gradient, one at the new latent) and the state after the
    strokes: (Z, IM, RECON) as numpy. (At the end, undo has restored the
    exact z_grid of set_latents.) `tail=False` leaves out scroll_patch and
    sample."""
    steps, decodes = 0, 1
    session.infer(image)
    for stroke in stroke_script()[:n_strokes]:
        steps += 1
        decodes += 2
        session.paint_stroke(*stroke)
    painted = (session.Z.cpu().numpy(), session.IM, session.RECON)
    if tail:
        session.scroll_patch(20, 20, 36, 36, +1, 0.5)  # shows the raw decode
        decodes += 2
    steps += 1  # set_latents, next
    decodes += 1
    session.set_latents(z_grid)
    if tail:
        session.sample(11)
        decodes += 1
    session.undo()
    return steps, decodes, painted


def captures_of(session):
    return {kind: p.captures for kind, p in session.runner.programs.items()}


def edit_captured_vs_eager(label, config, variables, image, z_grid, **options):
    """The whole script on the card through a captured session and through
    the runner's bodies called eagerly (`eager=True`), from the same weights
    and image, under deterministic algorithms: Z, IM, DELTA, RECON and
    decode_current equal bit for bit; each program captured once (infer,
    sample and decode_current through the encode and decode programs) while
    the brush moved, resized and switched sigma, the eager session's
    never."""
    from npe_tpu_torch.editor.engine import EditSession

    with deterministic_algorithms():
        sessions, painted = {}, {}
        for path in ("captured", "eager"):
            sessions[path] = EditSession(config, variables=variables, device="cuda", eager=path == "eager", **options)
            painted[path] = run_session_script(sessions[path], image, z_grid)[2]
    cap, eag = sessions["captured"], sessions["eager"]
    with deterministic_algorithms():
        shown = {path: s.decode_current() for path, s in sessions.items()}
    pairs = (("decode_current", shown["captured"], shown["eager"]),
             ("Z after the strokes", painted["captured"][0], painted["eager"][0]),
             ("IM after the strokes", painted["captured"][1], painted["eager"][1]),
             ("RECON", painted["captured"][2], painted["eager"][2]),
             ("DELTA", cap.DELTA, eag.DELTA), ("Z at the end", cap.Z.cpu().numpy(), eag.Z.cpu().numpy()),
             ("IM at the end", cap.IM, eag.IM))
    for name, a, b in pairs:
        assert np.array_equal(a, b), f"{label}: {name}, captured vs eager, differs by {max_err(a, b)}"
    assert captures_of(cap) == {"paint": 1, "scroll": 1, "composite": 1, "encode": 1, "decode": 1}, captures_of(cap)
    assert not any(captures_of(eag).values()), captures_of(eag)
    log(f"[main] {label}: captured session vs the runner's bodies called eagerly, whole script under "
        f"deterministic algorithms: Z, IM, DELTA, RECON and decode_current equal bit for bit; captures "
        f"{captures_of(cap)}")


def compare_sessions(label, card, cpu, card_painted, cpu_painted):
    """The card's session against the CPU's after the same script, under the
    Z / RECON / IM rules."""
    for name in ("IM", "DELTA", "RECON", "ERROR", "USER_MASK"):
        assert np.isfinite(getattr(card, name)).all(), f"{name} is not finite"
    assert all(np.isfinite(a).all() for a in card_painted)
    (z_a, im_a, recon_a), (z_b, im_b, recon_b) = card_painted, cpu_painted
    check_close(f"{label}: Z after the strokes, card vs cpu", z_a, z_b)
    check_recon_close(f"{label}: RECON card vs cpu", recon_a, recon_b)
    check_im_close(f"{label}: IM after the strokes, card vs cpu", im_a, im_b, recon_a, recon_b)
    check_im_close(f"{label}: IM at the end, card vs cpu", card.IM, cpu.IM, card.RECON, cpu.RECON)
    assert len(card._undo) == len(cpu._undo) and card.sample_flag == cpu.sample_flag


def compare_api(label, ian_card, ian_cpu, rng):
    x64 = rng.uniform(-1, 1, (64, 3, 64, 64)).astype(np.float32)
    z_card = ian_card.encode_images(x64)
    assert z_card.shape == (64, 100) and np.isfinite(z_card).all()
    check_close(f"{label}: encode_images b64 card vs cpu", z_card, ian_cpu.encode_images(x64))
    img_card = ian_card.sample_at(z_card)
    assert img_card.shape == (64, 3, 64, 64) and np.isfinite(img_card).all()
    check_close(f"{label}: sample_at b64 card vs cpu", img_card, ian_cpu.sample_at(z_card))
    z1 = z_card[:1]
    check_close(f"{label}: imgrad card vs cpu", ian_card.imgrad(8, 8, 24, 24, z1),
                ian_cpu.imgrad(8, 8, 24, 24, z1))
    rgb = np.broadcast_to(np.float32([0.5, -0.5, 0.2])[None, :, None, None], (1, 3, 64, 64))
    check_close(f"{label}: imgradRGB card vs cpu", ian_card.imgradRGB(8, 8, 24, 24, rgb, z1),
                ian_cpu.imgradRGB(8, 8, 24, 24, rgb, z1))


# --- api.IAN's programs: captured against eager, launches, times ---------------


def api_inputs(seed, n=64, zdim=100):
    """Images and latents for the API scripts, and one RGB target a box."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 3, 64, 64)).astype(np.float32)
    z = rng.randn(n, zdim).astype(np.float32)
    rgbs = [np.broadcast_to(rng.uniform(-1, 1, 3).astype(np.float32)[None, :, None, None], (1, 3, 64, 64))
            for _ in API_BOXES]
    return x, z, rgbs


def api_script(ian, x, z, rgbs):
    """The API's four methods: encode_images and sample_at at batch 1 and
    64, then imgrad and imgradRGB at batch 1 under each box of API_BOXES
    (moved and resized), each with another colour and other latents: six
    signatures, each captured once whatever the box, colour or latents.
    Returns every output, in API_OUTPUTS' order."""
    outs = [ian.encode_images(x[:1]), ian.encode_images(x), ian.sample_at(z[:1]), ian.sample_at(z)]
    for i, (box, rgb) in enumerate(zip(API_BOXES, rgbs)):
        outs += [ian.imgrad(*box, z[i:i + 1]), ian.imgradRGB(*box, rgb, z[i:i + 1])]
    return outs


def api_captures(ian):
    """{program: sorted captures of its signatures}."""
    out = {}
    for (name, _), n in ian.programs.captures().items():
        out.setdefault(name, []).append(n)
    return {name: sorted(v) for name, v in out.items()}


def drive_api(label, config, variables, counters, expect, seed, dtype=None, per_gradient=None, **forms):
    """api.IAN on the card, captured (its path) and eager (`eager=True`), on
    the same weights and inputs under deterministic algorithms: the captured
    script twice, its first run making the six programs (an eager call and
    a capture each), its second, on other images, latents and colours, all
    replays, under the profiler, the counts
    set to 0 just before and read just after, held to the device kernels it
    recorded and to `expect` ({kernel: launches a decode}; API_DECODES
    decodes a script) and `per_gradient` ({kernel: launches a gradient
    call}; API_GRADIENTS a script); every output of both runs equal to the eager twin's
    bit for bit; each of the six signatures captured once, the eager twin's
    never. Returns the replayed script's launches."""
    from npe_tpu_torch.api import IAN

    with deterministic_algorithms():
        cap = IAN(config, variables=variables, device="cuda", dtype=dtype, **forms)
        eag = IAN(config, variables=variables, device="cuda", dtype=dtype, eager=True, **forms)
        x, z, rgbs = api_inputs(seed, zdim=cap.get_zdim())
        other = api_inputs(seed + 100, zdim=cap.get_zdim())
        first = api_script(cap, x, z, rgbs)
        counters.zero()
        replayed, seen = profiled(lambda: api_script(cap, *other))
        launches = counters.read()
        want = api_script(eag, x, z, rgbs)
        want_other = api_script(eag, *other)
    for run, got, twin in (("first run", first, want), ("replayed", replayed, want_other)):
        for what, g, w in zip(API_OUTPUTS, got, twin):
            assert g.dtype == np.float32 and np.isfinite(g).all(), f"{label} api: {what} is not finite float32"
            assert np.array_equal(g, w), f"{label} api, {run}: {what}, captured vs eager, differs by {max_err(g, w)}"
    check_witnessed(f"{label} api, replayed", launches, seen)
    for name, n in launches.items():
        want = API_DECODES * expect.get(name, 0) + API_GRADIENTS * (per_gradient or {}).get(name, 0)
        assert n == want, f"{label} api: {name} launched {n} times, not {want}"
    assert all(np.abs(g).max() > 0 for g in first[4:]), f"{label} api: a gradient is zero"
    caps = api_captures(cap)
    assert caps == {"encode": [1, 1], "sample": [1, 1], "imgrad": [1], "imgrad_rgb": [1]}, caps
    assert not any(n for v in api_captures(eag).values() for n in v), api_captures(eag)
    log(f"[api] {label}: captured api.IAN vs eager, {len(API_OUTPUTS)} outputs of the first run and of the "
        f"replayed one equal bit for bit under deterministic algorithms while the box moved and resized and the "
        f"colour and latents changed; captures {caps}; launches of the replayed script {launches}")
    return launches


def time_api(label, config, variables, smi, dtype=None, **forms):
    """api.IAN captured beside eager, one fresh IAN each: p50 / p95 of
    imgrad and imgradRGB at batch 1 and of encode_images and sample_at at
    batch 1 and 64 (host clock; each call ends in a download), each
    program's first call (on the captured path the eager call and the
    capture), and the peak device memory the IAN adds (its buffers, pool and
    workspaces)."""
    from npe_tpu_torch.api import IAN

    out = {}
    for path in ("captured", "eager"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ian = IAN(config, variables=variables, device="cuda", dtype=dtype, eager=path == "eager", **forms)
        x, z, rgbs = api_inputs(31, zdim=ian.get_zdim())
        calls = (("imgrad b1", lambda: ian.imgrad(8, 8, 24, 24, z[:1]), API_TIMED),  # noqa: B023
                 ("imgradRGB b1", lambda: ian.imgradRGB(8, 8, 24, 24, rgbs[0], z[:1]), API_TIMED),  # noqa: B023
                 ("encode_images b1", lambda: ian.encode_images(x[:1]), API_TIMED),  # noqa: B023
                 ("encode_images b64", lambda: ian.encode_images(x), API_TIMED_B64),  # noqa: B023
                 ("sample_at b1", lambda: ian.sample_at(z[:1]), API_TIMED),  # noqa: B023
                 ("sample_at b64", lambda: ian.sample_at(z), API_TIMED_B64))  # noqa: B023
        res = {}
        for what, call, n in calls:
            t0 = time.perf_counter()
            call()
            first = (time.perf_counter() - t0) * 1e3
            ms = []
            for _ in range(n):
                t0 = time.perf_counter()
                call()
                ms.append((time.perf_counter() - t0) * 1e3)
            p50, p95 = np.percentile(ms, [50, 95])
            res[what] = {"p50_ms": float(p50), "p95_ms": float(p95), "first_call_ms": first, "calls": n}
        res["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        out[path] = res
        del ian
    line = ", ".join(f"{what} {out['captured'][what]['p50_ms']:.4f} / {out['eager'][what]['p50_ms']:.4f} ms "
                     f"(first call {out['captured'][what]['first_call_ms']:.1f} / {out['eager'][what]['first_call_ms']:.1f})"
                     for what, _, _ in calls)
    log(f"[time] {label} api.IAN p50 captured / eager: {line}; peak device memory the IAN adds "
        f"{out['captured']['peak_mb']:.1f} / {out['eager']['peak_mb']:.1f} MiB ({smi})")
    return out


def inference_mode_trap():
    """The inference-mode trap, in a process of its own (run by the `--trap` argument),
    where no constant has been built yet: three servers (IANv1 with the head
    in either kernel form, full IAN with the fused head and the fused
    MDBLOCKs) capture their graphs under the dispatcher's inference_mode
    first, building the head's and the s2d constants there; then api.IAN's
    captured imgrad and imgradRGB with the same forms, against the CPU's on
    the same weights within the golden tolerance. Returns 0, or raises."""
    from npe_tpu_torch.api import IAN
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.ops import conv, mdcl
    from npe_tpu_torch.ops.kernels import rgb_beta_head as rh
    from npe_tpu_torch.serving import InferenceServer
    from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    caches = {"ops/conv.py _s2d_gather": conv._s2d_gather, "ops/mdcl.py _placement": mdcl._placement,
              "ops/kernels/rgb_beta_head.py _placement": rh._placement}
    assert not any(c.cache_info().currsize for c in caches.values()), "a constant was built before the trap"
    cases = (("IANv1 fused head", "IANv1", {"head_mode": "fused"}),
             ("IANv1 hybrid head", "IANv1", {"head_mode": "hybrid"}),
             ("IAN fused head and MDBLOCKs", "IAN", {"head_mode": "fused", "mdblock_mode": "fused"}))
    weights = {}
    for config in ("IANv1", "IAN"):
        seeded = get_config(config).init(torch.Generator().manual_seed(0), "cpu")
        weights[config] = unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    for label, config, forms in cases:
        server = InferenceServer(config, variables=from_reference(weights[config], "cuda"), max_batch=4,
                                 device="cuda", **forms)
        try:
            z = server.encode(x).result(timeout=SERVE_WAIT)
            y = server.decode(z).result(timeout=SERVE_WAIT)
            assert np.isfinite(y).all() and server.programs.captures() and all(server.programs.captures().values())
        finally:
            server.close()
    built = {name: c.cache_info().currsize for name, c in caches.items()}
    print(f"[trap] three servers captured under inference_mode first; constants built there: {built}", flush=True)
    assert built["ops/conv.py _s2d_gather"], built
    rgb = np.broadcast_to(np.float32([0.5, -0.5, 0.2])[None, :, None, None], (1, 3, 64, 64))
    for label, config, forms in cases:
        card = IAN(config, variables=from_reference(weights[config], "cuda"), device="cuda", **forms)
        cpu = IAN(config, variables=from_reference(weights[config], "cpu"), device="cpu")
        z1 = np.random.RandomState(6).randn(1, card.get_zdim()).astype(np.float32)
        for what, got, want in (("imgrad", card.imgrad(8, 8, 24, 24, z1), cpu.imgrad(8, 8, 24, 24, z1)),
                                ("imgradRGB", card.imgradRGB(8, 8, 24, 24, rgb, z1),
                                 cpu.imgradRGB(8, 8, 24, 24, rgb, z1))):
            assert np.abs(got).max() > 0
            check_close(f"[trap] {label}: captured {what} after the servers' inference_mode captures, card vs cpu",
                        got, want)
        assert all(card.programs.captures().values()), card.programs.captures()
    print("[trap] ok", flush=True)
    return 0


def check_trap(root):
    """`inference_mode_trap` in a new process, with a time limit; its lines
    are logged."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"), "--trap"], cwd=root,
                          capture_output=True, text=True, timeout=DP_TIMEOUT)
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    assert proc.returncode == 0 and "[trap] ok" in proc.stdout, proc.stderr[-4000:]
    log(f"[api] the inference-mode trap in a process of its own: servers captured under inference_mode first, then "
        f"api.IAN's captured gradients with the fused head, the hybrid head and the fused MDBLOCKs match the "
        f"CPU ({time.perf_counter() - t0:.1f} s)")


def time_strokes(label, session, image, smi, n=TIMED_STROKES):
    """p50 / p95 of paint_stroke over `n` strokes on the host's clock (each
    ends in a device-to-host copy): bench_torch_edit.py's loop."""
    p50, p95 = np.percentile(bench_torch_edit.stroke_times(session, image, n), [50, 95])
    log(f"[time] {label} paint_stroke over {n} strokes: p50 {p50:.4f} ms, "
        f"p95 {p95:.4f} ms ({smi})")
    return p50, p95


def profile_strokes(label, session, top):
    """torch.profiler over PROFILED_STROKES strokes: device time by kernel
    name, the device's idle share and the host's launches a stroke. Returns
    (device kernel ms a stroke, idle share, host launches a stroke), or
    Nones if the profiler recorded no device time."""
    busy, idle, kernels, launches = bench_torch_edit.device_ms_per_stroke(session, PROFILED_STROKES)
    if busy is None:
        log(f"[time] {label} profiler: no device time recorded (idle share not measured)")
        return None, None, None
    log(f"[time] {label} profiler, {PROFILED_STROKES} strokes: device kernels {busy:.4f} ms a stroke (idle share "
        f"{idle:.3f}); host launches {launches:.1f} a stroke; kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[time]   {e.self_device_time_total / PROFILED_STROKES:9.2f} us/stroke  "
            f"{e.count / PROFILED_STROKES:5.1f}x  {e.key[:90]}")
    return busy, idle, launches


def time_edit_paths(label, session, image, smi, n, top):
    """The captured session's strokes beside an eager twin's (the same
    weights, form and dtype, `eager=True`): p50 / p95 over `n` strokes (a
    quarter as many eager, at least 8), device ms a stroke, idle share and
    host launches a stroke, by path."""
    from npe_tpu_torch.editor.engine import EditSession

    eager = EditSession(session.module.cfg["model"], variables=session.variables, device="cuda",
                        dtype=session.dtype, eager=True, **session.decode_options)
    out = {}
    for path, s, strokes, shown in (("captured", session, n, top), ("eager", eager, max(8, n // 4), 3)):
        p50, p95 = time_strokes(f"{label} {path}", s, image, smi, strokes)
        busy, idle, launches = profile_strokes(f"{label} {path}", s, shown)
        out[path] = {"p50_ms": p50, "p95_ms": p95, "strokes": strokes, "device_ms_per_stroke": busy,
                     "idle_share": idle, "host_launches_per_stroke": launches}
    assert not any(captures_of(eager).values()) and captures_of(session)["paint"] == 1, captures_of(session)
    log(f"[time] {label}: captured p50 {out['captured']['p50_ms']:.4f} ms against eager {out['eager']['p50_ms']:.4f} "
        f"({out['eager']['p50_ms'] / out['captured']['p50_ms']:.2f}x) ({smi})")
    return out


def editor_first_calls(label, config, variables, image, z_grid, smi, **forms):
    """A fresh captured session: each editor step's first call (on the card
    the eager call and the capture of its programs) beside its second (a
    replay), host clock: infer (encode and decode), paint_stroke,
    scroll_patch, set_latents and sample (whose decode infer captured)."""
    from npe_tpu_torch.editor.engine import EditSession

    s = EditSession(config, variables=variables, dim=z_grid.shape, device="cuda", **forms)
    strokes = stroke_script()
    steps = (("infer", lambda i: s.infer(image)), ("paint_stroke", lambda i: s.paint_stroke(*strokes[i])),
             ("scroll_patch", lambda i: s.scroll_patch(20, 20, 36, 36, +1, 0.5)),
             ("set_latents", lambda i: s.set_latents(z_grid * (i + 1))), ("sample", lambda i: s.sample(11 + i)))
    out = {}
    for what, step in steps:
        ms = []
        for i in range(2):
            t0 = time.perf_counter()
            step(i)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[what] = {"first_ms": ms[0], "second_ms": ms[1]}
    assert all(p.captures == 1 for p in s.runner.programs.values()), captures_of(s)
    log(f"[time] {label} editor, first call / second call, ms: "
        + ", ".join(f"{what} {t['first_ms']:.1f} / {t['second_ms']:.3f}" for what, t in out.items()) + f" ({smi})")
    return out


def staging_bound_ms(n, chw):
    """Least time for the staging kernel: a byte read and four written per
    pixel and one index per row; a multiply and a subtract per pixel."""
    return roofline_ms(n * chw * 5 + 8 * n, 2 * n * chw)


def check_staging(staging, dev, worst):
    """The staging kernel against its plain version on the card, at the
    trainer's shapes and at the edges of what it takes."""
    rng = np.random.RandomState(12)
    cache = torch.from_numpy(rng.randint(0, 256, (16384, 3, 64, 64), dtype=np.uint8)).to(dev)
    small = torch.from_numpy(rng.randint(0, 256, (40, 3, 16, 16), dtype=np.uint8)).to(dev)
    cases = [("M 16384 n 8192 3x64x64, repeats, int64", cache, rng.randint(0, 16384, 8192)),
             ("M 16384 n 8192, int32", cache, rng.randint(0, 16384, 8192).astype(np.int32)),
             ("M 16384 n 1000", cache, rng.randint(0, 16384, 1000)),
             ("M 16384 n 1, the last row", cache, np.array([16383])),
             ("M 1024 identity", cache[:1024], None),
             ("indices already on the card", cache, torch.from_numpy(rng.permutation(16384)[:1024]).to(dev)),
             ("M 40 n 100 3x16x16", small, rng.randint(0, 40, 100))]
    for case, src, perm in cases:
        before = staging.stage_chunk.launches
        got = staging.stage_chunk(src, perm)
        torch.cuda.synchronize()
        assert staging.stage_chunk.launches == before + 1
        idx = None if perm is None else torch.as_tensor(perm).to(dev).long()
        want = staging.stage_chunk_reference(src, idx)
        e = float((got - want).abs().max())
        worst["staging"] = max(worst["staging"], e)
        lo, hi = float(got.min()), float(got.max())
        log(f"[kernel] staging {case}: max abs err {e:.3e} (tol {STAGING_TOL}), range [{lo:.7f}, {hi:.7f}]")
        assert got.shape == want.shape and got.dtype == torch.float32 and e <= STAGING_TOL
        assert -1 - STAGING_TOL <= lo and hi <= 1 + STAGING_TOL
    for what, error, call in (
            ("a 3x5x5 input", ValueError, lambda: staging.stage_chunk(torch.zeros((4, 3, 5, 5), dtype=torch.uint8, device=dev))),
            ("a float input", TypeError, lambda: staging.stage_chunk(cache[:4].float())),
            ("a host index beyond the chunk", IndexError, lambda: staging.stage_chunk(cache, np.array([16384])))):
        before = staging.stage_chunk.launches
        try:
            call()
        except error as exc:
            log(f"[kernel] staging raises on {what}: {type(exc).__name__}")
        else:
            raise AssertionError(f"staging took {what}")
        assert staging.stage_chunk.launches == before
    return cache


def read_metrics(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def drive_training(counters):
    """The trainer's main path: `train` on IAN_simple at full width on the
    card, two epochs of two chunks from the device-resident dataset, then a
    resumed third epoch with per-chunk uploads. Returns the staging kernel's
    launches of the first run (counts set to 0 just before it)."""
    from npe_tpu_torch.training import train as tt
    from npe_tpu_torch.training import train_step as ts
    from npe_tpu_torch.utils import checkpoints as ck

    chunk = TRAIN_BATCH * TRAIN_BATCHES_PER_CHUNK
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(config="IAN_simple", dataset_spec="synthetic", num_examples=TRAIN_EXAMPLES, out_dir=tmp,
                  pics_dir=os.path.join(tmp, "pics"), checkpoint_grids=False,
                  cfg_overrides={"batches_per_chunk": TRAIN_BATCHES_PER_CHUNK})
        counters.zero()
        t0 = time.perf_counter()
        state = tt.train(max_epochs=2, **kw)
        torch.cuda.synchronize()
        launches = counters.read()
        log(f"[train] IAN_simple batch {TRAIN_BATCH}, {TRAIN_EXAMPLES} examples, 2 epochs of 2 chunks of "
            f"{TRAIN_BATCHES_PER_CHUNK} batches, dataset on the card: {time.perf_counter() - t0:.2f} s; launches {launches}")
        assert launches["staging"] == 4, launches  # one per chunk
        assert all(n == 0 for name, n in launches.items() if name != "staging"), launches
        assert all(t.is_cuda for t in ts.variables_of(state).values())
        files = {n: os.path.join(tmp, "IAN_simple" + n) for n in (".npz", "_train_state.npz", "METRICS.jsonl")}
        recs = read_metrics(files["METRICS.jsonl"])
        assert [r["itr"] for r in recs] == [8, 16, 24, 32] and [r["epoch"] for r in recs] == [0, 0, 1, 1], recs
        meta = ck.train_state_metadata(files["_train_state.npz"])
        assert (meta["epoch"], meta["itr"]) == (1, 32), meta
        loaded = ck.load_train_state(files["_train_state.npz"])
        assert int(loaded["step"]) == 32 and int(loaded["opt"]["latent"]["count"]) == 32
        assert int(loaded["opt"]["gen"]["count"]) == int(loaded["opt"]["discrim"]["count"]) == 16
        for part, variables in state["parts"].items():
            for k, v in variables.items():
                assert torch.equal(loaded["parts"][part][k], v), k
        fresh = {k: torch.zeros_like(v) for k, v in ts.variables_of(state).items()}
        assert ck.load_weights(files[".npz"], fresh)["itr"] == 32
        assert all(torch.equal(fresh[k], v) for k, v in ts.variables_of(state).items())

        counters.zero()
        t0 = time.perf_counter()
        resumed = tt.train(max_epochs=3, resume=True, device_cache_bytes=0, **kw)
        torch.cuda.synchronize()
        log(f"[train] resumed for a third epoch, chunks sent up from pinned memory: {time.perf_counter() - t0:.2f} s; "
            f"staging launches {counters.read()['staging']}")
        assert counters.read()["staging"] == 2
        recs = read_metrics(files["METRICS.jsonl"])
        assert [r["itr"] for r in recs] == [8, 16, 24, 32, 40, 48] and recs[-1]["epoch"] == 2, recs
        for r in recs:
            assert sorted(r["metrics"]) == sorted(set(tt.GEN_KEYS + tt.DISCRIM_KEYS))
            assert all(np.isfinite(v) for v in r["metrics"].values()), r
        assert int(resumed["step"]) == 48 and ck.train_state_metadata(files["_train_state.npz"])["epoch"] == 2
        log(f"[train] 6 metrics records finite, itr 8..48 across the resume; last: "
            f"{ {k: round(v, 4) for k, v in recs[-1]['metrics'].items()} }")
    return launches["staging"]


def step_batch(cfg, batch, seed, device, dtype=torch.float32):
    """(x, z_rand, noise) on `device`: procedural faces and seeded normals."""
    from npe_tpu_torch.data import SyntheticFaces

    rng = np.random.RandomState(seed)
    faces = SyntheticFaces(256).get_data(rng.choice(256, batch, replace=False))
    x = torch.from_numpy(faces.astype(np.float32) / 127.5 - 1)
    z, eps = (torch.from_numpy(rng.randn(batch, cfg["num_latents"]).astype(np.float32)) for _ in range(2))
    return [t.to(device=device, dtype=dtype) for t in (x, z, eps)]


def step_results(module, variables, batch, dtype=torch.float32):
    """One G and one D step's metrics and gradients (not applied) from
    `variables`, on their device."""
    from npe_tpu_torch.training import graph, losses
    from npe_tpu_torch.training import train_step as ts

    cfg = dict(module.cfg)
    parts = losses.partition_variables({k: v.to(dtype) for k, v in variables.items()})
    out = {}
    for player, grads_fn in (("gen", ts.gen_grads), ("discrim", ts.discrim_grads)):
        g_player, g_latent, fwd, upd = grads_fn(module, cfg, parts, *batch)
        metrics = graph.compute_metrics(cfg, fwd, batch[0], module.N_DISCRIM_CLASSES)
        out[player] = ({k: float(v) for k, v in metrics.items()},
                       {k: g.cpu().numpy() for k, g in {**g_player, **g_latent}.items()},
                       {k: v.cpu().numpy() for k, v in upd.items()})
    return out


def compare_steps(label, card, cpu, grad_tol):
    for player in ("gen", "discrim"):
        (m_a, g_a, u_a), (m_b, g_b, u_b) = card[player], cpu[player]
        assert all(np.isfinite(v) for v in m_a.values()), m_a
        for k in m_b:
            np.testing.assert_allclose(m_a[k], m_b[k], rtol=RTOL, atol=ATOL, err_msg=f"{label} {player} {k}")
        for k in u_b:
            np.testing.assert_allclose(u_a[k], u_b[k], rtol=RTOL, atol=ATOL, err_msg=f"{label} {player} {k}")
        worst_g = 0.0
        for k, want in g_b.items():
            largest = np.abs(want).max()
            np.testing.assert_allclose(g_a[k], want, rtol=0, atol=grad_tol * largest + 1e-7,
                                       err_msg=f"{label} {player} gradient {k}")
            if largest > 1e-6:
                worst_g = max(worst_g, np.abs(g_a[k] - want).max() / largest)
        log(f"  {label}, {player} step card vs cpu: {len(m_b)} metrics and {len(u_b)} BN statistics within rtol {RTOL} "
            f"/ atol {ATOL}; {len(g_b)} gradients within {grad_tol} of each one's largest value (worst {worst_g:.3e})")


def kernel_steps(label, module, variables, counters, batch_size=16):
    """One G and one D step of an RGB-Beta-head model on the card, through
    `make_train_steps`: each step decodes twice (the reconstruction and the
    sample), each decode launches rgb_beta_tail once, its backward runs three
    times a pair (the G step's two decodes, the trunk's and the taps'
    gradients; the D step's reconstruction, the trunk's alone), and the
    MDBLOCKs take the per-op form under training. Frozen weights and masks
    stay bit-equal."""
    from npe_tpu_torch.training import train_step as ts

    cfg = dict(module.cfg, batch_size=batch_size)
    state0 = ts.init_train_state(module, variables, cfg)
    batch = step_batch(cfg, batch_size, 31, "cuda")
    counters.zero()
    gen_step, discrim_step = ts.make_train_steps(module, cfg)
    state, m_g = gen_step(state0, *batch, 2e-4)
    state, m_d = discrim_step(state, *batch, 2e-4)
    torch.cuda.synchronize()
    launches = counters.read()
    log(f"[train] {label} batch {batch_size}, one G and one D step on the card: launches {launches}; "
        f"G pixel_loss {float(m_g['pixel_loss']):.4f}, D discrim_acc {float(m_d['discrim_acc']):.4f}")
    assert launches["rgb_beta_tail"] == 4 and launches["rgb_beta_tail_bwd"] == TAIL_BWD_PER_PAIR, launches
    assert launches["mdblock"] == 0 and launches["rgb_beta_head"] == 0, launches
    assert all(np.isfinite(float(v)) for m in (m_g, m_d) for v in m.values())
    frozen = [k for k in state0["parts"]["frozen"]] + [k for k in state0["parts"]["state"] if k.endswith(".weights_mask")]
    assert len(frozen) > 6
    for k in frozen:
        part = "frozen" if k in state0["parts"]["frozen"] else "state"
        assert torch.equal(state["parts"][part][k], state0["parts"][part][k]), k
    for part in ("gen", "latent", "discrim"):
        assert any(not torch.equal(state["parts"][part][k], v) for k, v in state0["parts"][part].items()), part
        assert all(torch.isfinite(v).all() for v in state["parts"][part].values()), part
    return launches["rgb_beta_tail"]


def bf16_steps(label, module, variables, counters, batch_size, expect_tail):
    """One G and one D step from `variables` in float32 and in bf16
    (cfg['compute_dtype']), on the same batch and noise: each run with the
    counts set to 0 just before it. Under bf16 each decode (two a step)
    launches the tail's bf16 form when the model has the RGB-Beta head
    (`expect_tail`), and its backward's bf16 form runs TAIL_BWD_PER_PAIR
    times; nothing else launches. Masters, moments and BN
    statistics stay float32; frozen weights and masks bit-equal. Returns
    ({dtype: (G pixel_loss, G kl, D discrim_d_loss)}, the bf16 launches)."""
    from npe_tpu_torch.training import train_step as ts

    cfg32 = dict(module.cfg, batch_size=batch_size)
    batch = step_batch(cfg32, batch_size, 36, "cuda")
    rows, launches = {}, {}
    for name, cfg in (("float32", cfg32), ("bfloat16", dict(cfg32, compute_dtype="bfloat16"))):
        state0 = ts.init_train_state(module, variables, cfg)
        gen_step, discrim_step = ts.make_train_steps(module, cfg)
        counters.zero()
        state, m_g = gen_step(state0, *batch, 2e-4)
        state, m_d = discrim_step(state, *batch, 2e-4)
        torch.cuda.synchronize()
        launches[name] = counters.read()
        rows[name] = (float(m_g["pixel_loss"]), float(m_g["kl"]), float(m_d["discrim_d_loss"]))
        assert all(np.isfinite(float(v)) for m in (m_g, m_d) for v in m.values()), (label, name)
        for part in ("gen", "latent", "discrim", "frozen"):
            assert all(t.dtype == torch.float32 for t in state["parts"][part].values()), (label, name, part)
        for part in ("gen", "latent", "discrim"):
            opt = state["opt"][part]
            assert all(t.dtype == torch.float32 for m in ("mu", "nu") for t in opt[m].values()), (label, part)
            assert any(not torch.equal(state["parts"][part][k], v) for k, v in state0["parts"][part].items()), part
        for k, t in state["parts"]["state"].items():
            assert t.dtype == torch.float32, k
            if k.endswith(".weights_mask"):
                assert torch.equal(t, state0["parts"]["state"][k]), k
        for k, t in state["parts"]["frozen"].items():
            assert torch.equal(t, state0["parts"]["frozen"][k]), k
    tail, bwd = (4, TAIL_BWD_PER_PAIR) if expect_tail else (0, 0)
    want = {name: 0 for name in counters.forms}
    assert launches["bfloat16"] == dict(want, rgb_beta_tail_bf16=tail, rgb_beta_tail_bwd_bf16=bwd), (label, launches)
    assert launches["float32"] == dict(want, rgb_beta_tail=tail, rgb_beta_tail_bwd=bwd), (label, launches)
    log(f"[train] {label} batch {batch_size}, one G and one D step in bf16 and in float32 on the same weights and "
        f"batch: (G pixel_loss, G kl, D discrim_d_loss) bf16 {np.round(rows['bfloat16'], 5).tolist()}, float32 "
        f"{np.round(rows['float32'], 5).tolist()}; bf16 launches {launches['bfloat16']}; masters, moments and BN "
        f"statistics float32, frozen weights and masks unchanged")
    return rows, launches["bfloat16"]


def flat_state(state):
    """{path tuple: tensor} of a train state (`training.captured.flatten`)."""
    from npe_tpu_torch.training.captured import flatten

    return dict(flatten(state))


def check_train_state(label, got, want, start):
    """A float32 train state after some steps on the card against another
    run's from the same start (`flat_state`'s), by phase 8's rule per
    tensor in norm (`check_moments`: within DP_MU_REL of |want| plus
    DP_MU_FLOOR of the part's largest value times sqrt(size)): the Adam
    moments and the BN statistics as they are, the parameters by what the
    steps moved them (got - start against want - start). A parameter whose
    gradient is rounding noise (its first moment within the floor, as a
    bias before a batch norm has) is held through its moments alone: Adam
    moves it by sign-like steps of lr either way. What is not floating, and
    the frozen weights, are equal. Returns the rule and the worst readings
    as a line of text."""
    groups, noise = {}, []
    for path, w in want.items():
        if not w.is_floating_point() or path[:2] == ("parts", "frozen"):
            assert torch.equal(got[path], w), (label, path)
        elif path[0] == "opt" or path[:2] == ("parts", "state"):
            groups.setdefault("/".join(path[:-1]), {})[path[-1]] = (got[path], w)
    for part in ("gen", "latent", "discrim"):
        mu = {path[-1]: w for path, w in want.items() if path[:3] == ("opt", part, "mu")}
        scale = max(float(t.abs().max()) for t in mu.values())
        for path, w in want.items():
            if path[:2] != ("parts", part):
                continue
            if float(mu[path[-1]].float().norm()) <= DP_MU_FLOOR * scale * w.numel() ** 0.5:
                noise.append("/".join(path[1:]))
            else:
                groups.setdefault(f"steps of parts/{part}", {})[path[-1]] = (got[path] - start[path],
                                                                           w - start[path])
    got = {g: {k: a for k, (a, _) in d.items()} for g, d in groups.items()}
    want = {g: {k: b for k, (_, b) in d.items()} for g, d in groups.items()}
    (worst, where), (worst_elt, where_elt) = check_moments(f"{label} captured vs eager", got, want)
    return (f"parameters' steps, Adam moments and BN statistics per tensor in norm within {DP_MU_REL} of |want| + "
            f"{DP_MU_FLOOR} of the part's largest (worst {worst:.3e} at {where}; worst element {worst_elt:.3e} of its "
            f"tensor's largest at {where_elt}); {len(noise)} parameters with rounding-noise gradients held through "
            f"their moments ({', '.join(noise[:4])}{', ...' if len(noise) > 4 else ''})")


def captured_vs_eager(label, module, variables, counters, dtype, batch_size=16, nb=CAPTURE_STEPS):
    """One chunk of `nb` steps from the same state, generator seed and
    batch, captured (`make_chunk_rows`, the trainer's path: an eager G and
    D, then each captured and replayed) and eager, under
    `deterministic_algorithms`, each with the counts set to 0 just before it.
    float64 (IAN_simple, no hand kernel on its path): the metric rows and
    every tensor of the state to CAPTURE64_TOL of its largest value;
    float32 (IANv1, full IAN, through the tail kernel): the rows at the
    golden tolerance and the state by `check_train_state`. The launches of
    the two paths are equal. Returns the captured path's launches."""
    from npe_tpu_torch.training import train_step as ts

    cfg = dict(module.cfg, batch_size=batch_size)
    state0 = ts.init_train_state(module, {k: v.to(dtype) if v.is_floating_point() else v
                                          for k, v in variables.items()}, cfg)
    rng = np.random.RandomState(37)
    x_chunk = torch.from_numpy(rng.uniform(-0.9, 0.9, (nb * batch_size, 3, 64, 64))).to(device="cuda", dtype=dtype)
    out = {}
    with deterministic_algorithms():
        for name in ("eager", "captured"):
            rows = ts.make_chunk_rows(module, cfg, nb, eager=name == "eager")
            counters.zero()
            t0 = time.perf_counter()
            state, keys, table, flags, _ = rows(state0, x_chunk, 0, torch.Generator("cuda").manual_seed(6), 2e-4)
            torch.cuda.synchronize()
            out[name] = (keys, table.cpu().numpy(), flags, flat_state(state), counters.read(),
                         time.perf_counter() - t0, rows)
    (w_keys, w_table, w_flags, w_state, w_launches, w_s, _) = out["eager"]
    (g_keys, g_table, g_flags, g_state, g_launches, g_s, rows) = out["captured"]
    (runner,) = rows.runners.values()
    assert all(p.graph is not None and (p.calls, p.captures) == (nb // 2, 1) for p in runner.programs.values())
    assert (g_keys, g_flags) == (w_keys, w_flags) and g_launches == w_launches, (label, g_launches, w_launches)
    assert np.isfinite(g_table).all() and list(g_state) == list(w_state)
    assert all(not np.array_equal(g_table[i], g_table[i + 1]) for i in range(nb - 1)), label  # no aliased rows
    if dtype == torch.float64:
        np.testing.assert_allclose(g_table, w_table, rtol=CAPTURE64_TOL, atol=CAPTURE64_TOL, err_msg=label)
        worst = 0.0
        for path, w in w_state.items():
            scale = float(w.abs().max()) if w.is_floating_point() else 1.0
            err = float((g_state[path] - w).abs().max()) if w.numel() else 0.0
            assert err <= CAPTURE64_TOL * scale, (label, path, err, scale)
            worst = max(worst, err / max(scale, 1e-300))
        rule = f"rows and state within {CAPTURE64_TOL} (worst {worst:.3e} of a tensor's largest value)"
    else:
        np.testing.assert_allclose(g_table, w_table, rtol=RTOL, atol=ATOL, err_msg=label)
        rule = check_train_state(label, g_state, w_state, flat_state(state0))
    log(f"[train] {label} {str(dtype).split('.')[1]} batch {batch_size}, a chunk of {nb} steps captured vs eager from "
        f"the same state: {rule}; launches {g_launches} on both; eager {w_s:.2f} s, captured {g_s:.2f} s "
        "(captures included)")
    return g_launches


def drive_training_bf16(counters, smi):
    """`train()` on IAN_simple at batch 128 through every hook at once: a
    `native:` raw file written by `export_raw`, `compute_dtype` bfloat16, a
    validation set with encoder-FID, a profiler trace of the first chunk and
    the checkpoint grid; then a resumed epoch, which reads the FID basis back.
    Then the sample CLI writes its grid from the weights. Returns the staging
    kernel's launches in the two runs (counts set to 0 just before each)."""
    from npe_tpu_torch.data import SyntheticFaces, data_loader
    from npe_tpu_torch.data.native_loader import export_raw
    from npe_tpu_torch.models import ian_simple
    from npe_tpu_torch.training import sample
    from npe_tpu_torch.training import train as tt
    from npe_tpu_torch.training.quality import encoder_fid
    from npe_tpu_torch.utils import checkpoints as ck
    from npe_tpu_torch.utils.png import decode_rgb

    chunk = TRAIN_BATCH * TRAIN_BATCHES_PER_CHUNK
    staged = 0
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "train.raw")
        t0 = time.perf_counter()
        assert export_raw(SyntheticFaces(num_examples=TRAIN_EXAMPLES), raw) == (TRAIN_EXAMPLES, (3, 64, 64))
        log(f"[train] export_raw of {TRAIN_EXAMPLES} procedural faces: {time.perf_counter() - t0:.2f} s")
        trace_dir = os.path.join(tmp, "trace")
        kw = dict(config="IAN_simple", dataset_spec=f"native:{raw}", out_dir=tmp, pics_dir=os.path.join(tmp, "pics"),
                  valid_dataset_spec="synthetic", num_valid_examples=FID_EXAMPLES,
                  cfg_overrides={"batches_per_chunk": TRAIN_BATCHES_PER_CHUNK, "compute_dtype": "bfloat16"})
        files = {n: os.path.join(tmp, "IAN_simple" + n) for n in (".npz", "METRICS.jsonl", "_fid_basis.npz")}
        for epochs, extra in ((1, {"profile_dir": trace_dir}), (2, {"resume": True})):
            counters.zero()
            t0 = time.perf_counter()
            tt.train(max_epochs=epochs, **extra, **kw)
            torch.cuda.synchronize()
            launches = counters.read()
            chunks = (TRAIN_EXAMPLES - (epochs - 1) * TRAIN_BATCH // 2) // chunk  # the resumed epoch: half-batch offset
            log(f"[train] IAN_simple train() epoch {epochs - 1}{' (resumed)' if epochs > 1 else ''}, native: file, "
                f"bf16, validation with encoder-FID{', profiler trace' if epochs == 1 else ''}: "
                f"{time.perf_counter() - t0:.2f} s; launches {launches}")
            assert launches == dict({name: 0 for name in counters.forms}, staging=chunks), launches
            staged += launches["staging"]
            if epochs == 1:
                traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
                assert len(traces) == 1, traces
                with open(os.path.join(trace_dir, traces[0])) as fh:
                    events = json.load(fh)["traceEvents"]
                n_kernels = sum(e.get("cat") == "kernel" for e in events)
                graph_calls = {name: sum(e.get("name", "").startswith(name) for e in events)
                               for name in ("cudaStreamBeginCapture", "cudaGraphInstantiate", "cudaGraphLaunch")}
                log(f"[train] trace {traces[0]}: {len(events)} events, {n_kernels} of them the card's kernels; "
                    f"host calls {graph_calls}")
                assert n_kernels > 0
                with open(files["_fid_basis.npz"], "rb") as fh:
                    basis_bytes = fh.read()
        recs = read_metrics(files["METRICS.jsonl"])
        steps = [r for r in recs if "metrics" in r]
        valid = [r for r in recs if "validation" in r]
        assert len(steps) == 4 and all(np.isfinite(v) for r in steps for v in r["metrics"].values()), steps
        assert [r["epoch"] for r in valid] == [0, 1], valid
        fids = [r["validation"]["encoder_fid"] for r in valid]
        assert all(np.isfinite(f) and f > 0 for f in fids), fids
        assert os.path.isfile(os.path.join(tmp, "pics", "IAN_simple_1.png"))
        with open(files["_fid_basis.npz"], "rb") as fh:
            assert fh.read() == basis_bytes  # read back on resume, not taken anew
        # epoch 1's FID against epoch 0's basis, recomputed from the two files
        final, basis = (ian_simple.init(torch.Generator().manual_seed(0), "cuda") for _ in range(2))
        ck.load_weights(files[".npz"], final)
        ck.load_weights(files["_fid_basis.npz"], basis)
        real = next(iter(data_loader(dict(ian_simple.cfg, batch_size=TRAIN_BATCH,
                                          batches_per_chunk=FID_EXAMPLES // TRAIN_BATCH),
                                     SyntheticFaces(num_examples=FID_EXAMPLES), offset=0)))
        want = encoder_fid(ian_simple, final, real, num=FID_EXAMPLES, seed=1, feature_variables=basis)
        other = encoder_fid(ian_simple, final, real, num=FID_EXAMPLES, seed=1)
        log(f"[train] encoder_fid {fids} (epochs 0 and 1); epoch 1 recomputed against the saved basis {want:.4f}, "
            f"against the final weights' own features {other:.4f}")
        np.testing.assert_allclose(fids[1], want, rtol=1e-3)

        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            out = sample.main(["IAN_simple", "--epoch", "1", "--weights", files[".npz"]])
            with open(out, "rb") as fh:
                grid = decode_rgb(fh.read())
        finally:
            os.chdir(cwd)
        log(f"[train] sample CLI wrote {out}: {grid.shape}, std {grid.std():.1f}")
        assert grid.shape == (6 * 66 - 2, 9 * 66 - 2, 3) and grid.std() > 1
    return staged


def time_data_paths(smi, epochs=2):
    """ms to put one IAN_simple chunk (8 batches of 128) on the card as the
    trainer's float32 input, by each of its three data paths, host work
    included: gathered from the uint8 dataset resident on the card; the
    procedural dataset's bytes made on the host and sent up from pinned
    memory; the native loader's chunks of a raw file sent up the same way.
    Each ends in one `stage_chunk` launch and a synchronize."""
    from npe_tpu_torch.data import SyntheticFaces, data_loader, index_loader
    from npe_tpu_torch.data import native_loader as nl
    from npe_tpu_torch.ops.kernels.staging import stage_chunk

    cfg = {"batch_size": TRAIN_BATCH, "batches_per_chunk": TRAIN_BATCHES_PER_CHUNK}
    dataset = SyntheticFaces(num_examples=TRAIN_EXAMPLES)
    cache = torch.from_numpy(dataset.get_data(np.arange(TRAIN_EXAMPLES))).cuda()

    def upload(u8):
        return stage_chunk(torch.from_numpy(u8).pin_memory().cuda(non_blocking=True),
                           np.random.permutation(len(u8)))

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "train.raw")
        nl.export_raw(dataset, raw)
        native = nl.NativeChunkLoader(raw, TRAIN_EXAMPLES, (3, 64, 64), TRAIN_BATCH * TRAIN_BATCHES_PER_CHUNK)
        paths = {
            "resident": (lambda e: index_loader(cfg, TRAIN_EXAMPLES, shuffle=True, seed=e),
                         lambda idx: stage_chunk(cache, np.random.permutation(idx))),
            "pinned upload": (lambda e: data_loader(cfg, dataset, shuffle=True, seed=e, raw=True), upload),
            "native": (lambda e: nl.native_chunk_loader(cfg, None, None, shuffle=True, seed=e, loader=native,
                                                        raw=True), upload),
        }
        for name, (loader_of, stage) in paths.items():
            samples = []
            for e in range(epochs):
                it = iter(loader_of(e))
                while True:
                    t0 = time.perf_counter()
                    item = next(it, None)
                    if item is None:
                        break
                    x = stage(item)
                    torch.cuda.synchronize()
                    samples.append((time.perf_counter() - t0) * 1e3)
                    assert x.shape == (TRAIN_BATCH * TRAIN_BATCHES_PER_CHUNK, 3, 64, 64) and x.dtype == torch.float32
            times[name] = float(np.mean(samples))
            log(f"[time] IAN_simple data path '{name}': {times[name]:.3f} ms a chunk of "
                f"{TRAIN_BATCH * TRAIN_BATCHES_PER_CHUNK} images on the card (mean of {len(samples)}, host work "
                f"included) ({smi})")
        native.close()
    return times


def time_chunk(chunk_step, state, x_chunk):
    """ms of one chunk of `chunk_step` (CUDA events), after a warm chunk
    (for the captured chunk: its eager steps and its captures); returns
    (ms, state)."""
    gen = torch.Generator("cuda").manual_seed(1)
    state, *_ = chunk_step(state, x_chunk, 0, gen, 2e-4)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, *_ = chunk_step(state, x_chunk, 0, gen, 2e-4)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), state


def time_training(label, model, batch_size, batches_per_chunk, smi, counters, expect_tail, top, **cfg_extra):
    """The trainer's chunk of `batches_per_chunk` alternating steps on the
    same procedural faces from seeded default-init weights (what `train`
    starts from), eager (`make_chunk_step(eager=True)`) and then captured
    (the trainer's path), each as imgs/s over one chunk after a warm one,
    with its peak device memory (nothing of the other path alive) and a
    profile (`profile_steps`: 8 eager steps, one captured chunk); the eager
    path's ms per G and per D step (`make_train_steps`); the captured
    chunk's kernel launches (counts set to 0 just before it: two of the
    tail a step where the model has the RGB-Beta head, in the form of the
    compute dtype, and TAIL_BWD_PER_PAIR of its backward a G + D pair);
    last, alone on the card, bench_torch_train.py's rounds
    of captured G + D pairs. `cfg_extra`: e.g. compute_dtype="bfloat16".
    Returns ({"eager": ..., "captured": ...}, the captured launches)."""
    import bench_torch_train
    from npe_tpu_torch.data import SyntheticFaces
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.training import train_step as ts

    module = get_config(model)
    cfg = dict(module.cfg, batch_size=batch_size, batches_per_chunk=batches_per_chunk, **cfg_extra)
    variables = module.init(torch.Generator().manual_seed(0), "cuda")
    n = batch_size * batches_per_chunk
    # procedural faces in [-1, 1], as `train` stages them
    x_chunk = torch.from_numpy(SyntheticFaces(n).get_data(np.arange(n)).astype(np.float32) / 127.5 - 1).cuda()
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager_ms, state = time_chunk(ts.make_chunk_step(module, cfg, batches_per_chunk, eager=True),
                                 ts.init_train_state(module, variables, cfg), x_chunk)
    steps = ts.make_train_steps(module, cfg)
    batch = step_batch(cfg, batch_size, 33, "cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_step = {}
    for name, step in zip("GD", steps):
        start.record()
        for _ in range(8):
            state, _ = step(state, *batch, 2e-4)
        end.record()
        torch.cuda.synchronize()
        per_step[name] = start.elapsed_time(end) / 8
    out["eager"] = {"g_step_ms": per_step["G"], "d_step_ms": per_step["D"], "chunk_ms": eager_ms,
                    "imgs_per_s": n / eager_ms * 1e3, "peak_mib": torch.cuda.max_memory_allocated() / 2**20}

    def eager8():
        s = state
        for i in range(8):
            s, _ = steps[i % 2](s, *batch, 2e-4)

    out["eager"].update(zip(("device_ms_per_step", "idle_share", "conv_share"),
                            profile_steps(f"{label} eager", eager8, 8, top)))
    del state, eager8

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_step = ts.make_chunk_step(module, cfg, batches_per_chunk)
    gen = torch.Generator("cuda").manual_seed(1)
    state, *_ = chunk_step(ts.init_train_state(module, variables, cfg), x_chunk, 0, gen, 2e-4)  # warm
    torch.cuda.synchronize()
    counters.zero()
    start.record()
    state, gen_m, dis_m, _ = chunk_step(state, x_chunk, 0, gen, 2e-4)
    end.record()
    torch.cuda.synchronize()
    launches = counters.read()
    finite = all(np.isfinite(v) for v in torch.stack([*gen_m.values(), *dis_m.values()]).tolist())
    captured_ms = start.elapsed_time(end)
    bf16 = "_bf16" if cfg_extra.get("compute_dtype") == "bfloat16" else ""
    want = {name: 0 for name in counters.forms}
    if expect_tail:
        want["rgb_beta_tail" + bf16] = 2 * batches_per_chunk
        want["rgb_beta_tail_bwd" + bf16] = TAIL_BWD_PER_PAIR * batches_per_chunk // 2
    assert launches == want, (label, launches)
    out["captured"] = {"chunk_ms": captured_ms, "imgs_per_s": n / captured_ms * 1e3,
                       "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "launches": launches,
                       "metrics_finite": finite}
    log(f"[time] {label} training, batch {batch_size}: eager {per_step['G']:.3f} ms per G step, {per_step['D']:.3f} "
        f"ms per D step, {eager_ms:.2f} ms per chunk of {batches_per_chunk} alternating steps = "
        f"{out['eager']['imgs_per_s']:.1f} imgs/s, peak memory {out['eager']['peak_mib']:.0f} MiB; captured "
        f"{captured_ms:.2f} ms per chunk = {out['captured']['imgs_per_s']:.1f} imgs/s, peak memory "
        f"{out['captured']['peak_mib']:.0f} MiB, launches {launches}, its metrics finite: {finite} ({smi})")
    out["captured"].update(zip(("device_ms_per_step", "idle_share", "conv_share"), profile_steps(
        f"{label} captured", lambda: chunk_step(state, x_chunk, 0, gen, 2e-4), batches_per_chunk, top)))
    del chunk_step, state

    # bench_train.py's inputs are noise images; at default init IANv1's D step
    # gives a non-finite latent gradient from the second pair on at lr 2e-4
    # (card and CPU alike) and full IAN drifts there within a few hundred pairs
    # (docs/NUMERICS.md): both are timed at lr 0, the same program
    lr = 2e-4 if model == "IAN_simple" else 0.0
    bench = bench_torch_train.run(model=model, batch=batch_size, pairs=TRAIN_BENCH_PAIRS, rounds=TRAIN_BENCH_ROUNDS,
                                  compute_dtype=cfg_extra.get("compute_dtype"), lr=lr)
    out["captured"]["bench_torch_train"] = bench
    log(f"[time] {label} training, bench_torch_train.run (lr {lr}), captured G + D pairs: {bench['value']:.1f} imgs/s, "
        f"{bench['ms_per_step']:.3f} ms a step, spread {bench['spread_frac']:.3f}, mfu {bench['mfu']:.4f}, peak memory "
        f"{bench['peak_mib']:.0f} MiB, rounds {bench['round_times_s']} s, discarded {bench['discarded_round_times_s']} "
        f"({smi})")
    return out, launches


def profile_steps(label, run, n_steps, top):
    """torch.profiler over `run()`, which runs `n_steps` training steps:
    device kernel time a step, the device's idle share, the top kernels by
    name and the share of the device time in convolution kernels (cuDNN's,
    by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log(f"[time] {label} training profiler: no device time recorded (idle share not measured)")
        return None, None, None
    conv = sum(e.self_device_time_total for e in kernels if any(w in e.key.lower() for w in CONV_KERNEL_WORDS)) / 1e3
    log(f"[time] {label} training profiler, {n_steps} steps under the profiler: wall {wall:.2f} ms, device kernels "
        f"{busy:.2f} ms (idle share {1 - busy / wall:.3f}; convolution kernels by name {conv / busy:.3f} of the device "
        "time); kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[time]   {e.self_device_time_total / n_steps / 1e3:9.3f} ms/step  {e.count / n_steps:6.1f}x  "
            f"{e.key[:90]}")
    return busy / n_steps, 1 - busy / wall, conv / busy


# --- [eval]: the checkpoints' and the sample CLI's programs (training/programs.py) ---


def eval_calls(module):
    """[(program, rows)] of the [eval] script, at the shapes npe_tpu's
    programs take: the grid's, validation's `recon_mse` at the config's batch,
    the encoder-FID's features and sample-path decode at its batch, and the
    sample CLI's other functions (`decode`, `iaf`) at that batch too."""
    from npe_tpu_torch.training.programs import sample_program

    return list(EVAL_GRID) + [("recon_mse", module.cfg["batch_size"]), ("features", EVAL_FID_BATCH),
                              (sample_program(module), EVAL_FID_BATCH), ("decode", EVAL_FID_BATCH),
                              ("iaf", EVAL_FID_BATCH)]


def eval_inputs(calls, seed, zdim):
    """An input a call: procedural faces in [-1, 1] for the programs that
    take images (on the card for `recon_mse` and `features`, as the trainer
    gives them its validation slices and its samples; host arrays else, as it
    gives the grid's endpoints), seeded normals else (host arrays, as the
    grid's latents and the FID's CPU-generator draws)."""
    from npe_tpu_torch.data import SyntheticFaces
    from npe_tpu_torch.utils.ranges import to_tanh

    rng = np.random.RandomState(seed)
    out = []
    for i, (name, n) in enumerate(calls):
        if name in ("encode_pre_iaf", "recon_mse", "features"):
            x = to_tanh(np.float32(SyntheticFaces(n, seed=100 * seed + i).get_data(np.arange(n))))
            out.append(torch.from_numpy(x).cuda() if name != "encode_pre_iaf" else x)
        else:
            out.append(rng.randn(n, zdim).astype(np.float32))
    return out


def eval_script(owner, calls, inputs):
    """Every call of `calls` on its input; the outputs, tensors on the card."""
    return [owner(name, x) for (name, _), x in zip(calls, inputs)]


def seeded_variables(module, seed):
    """Seeded unit-gain weights on the card (the sessions' rule)."""
    from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain

    seeded = module.init(torch.Generator().manual_seed(seed), "cpu")
    return from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), "cuda")


def drive_eval(label, module, variables, second, counters, tail):
    """An `EvalPrograms` on the card, captured (the trainer's and the CLIs'
    path) and eager (`eager=True`), on the same weights and inputs under
    deterministic algorithms: the script three times, first making every
    signature (an eager call and a capture each), then on other inputs, all
    replays, under the profiler with the counts set to 0 just before and read
    just after, held to the device kernels it recorded (`tail`: the model
    decodes through rgb_beta_tail, once a decode), then on third inputs after
    `second` is loaded into both owners; every output of every run equal to
    the eager twin's bit for bit; each signature captured once, the eager
    twin's never. Returns the replayed script's launches."""
    from npe_tpu_torch.training.programs import EvalPrograms

    calls = eval_calls(module)
    zdim = module.cfg["num_latents"]
    with deterministic_algorithms():
        cap, eag = (EvalPrograms(module, "cuda", eager=e) for e in (False, True))
        for run, weights, seed in (("capturing", variables, 0), ("replayed", variables, 1),
                                   ("second weights", second, 2)):
            inputs = eval_inputs(calls, seed, zdim)
            for owner in (cap, eag):
                owner.load(weights)
            if run == "replayed":
                counters.zero()
                got, seen = profiled(lambda: eval_script(cap, calls, inputs))  # noqa: B023
                launches = counters.read()
            else:
                got = eval_script(cap, calls, inputs)
            want = eval_script(eag, calls, inputs)
            for (name, n), g, w in zip(calls, got, want):
                assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), f"{label} eval: {name} {n}"
                assert torch.equal(g, w), (f"{label} eval, {run}: {name} at {n} rows, captured vs eager, differs "
                                           f"by {max_err(g.cpu(), w.cpu())}")
    check_witnessed(f"{label} eval, replayed", launches, seen)
    decodes = sum(name in ("decode_pre_iaf", "decode", "recon_mse") for name, _ in calls)
    want = dict({name: 0 for name in counters.forms}, rgb_beta_tail=decodes if tail else 0)
    assert launches == want, f"{label} eval: launches {launches}, not {want}"
    caps = {f"{key[0]} {key[1][0][0][0]}": n for key, n in cap.programs.captures().items()}
    assert sorted(caps) == sorted({f"{name} {n}" for name, n in calls}) and set(caps.values()) == {1}, caps
    assert not any(eag.programs.captures().values())
    log(f"[eval] {label}: captured programs vs eager, {len(calls)} outputs of the capturing run, of the replayed "
        f"one on other inputs and of a run on a second set of weights equal bit for bit under deterministic "
        f"algorithms; captures {caps}; launches of the replayed script {launches}")
    return launches


def eval_checkpoint(module, variables, valid, real, current, basis, png):
    """One checkpoint's evaluation as `train()` runs it: the current weights
    loaded into `current`, the grid (written to `png`), validation with
    max_chunks=1 over `valid`, the encoder-FID of `real` against the `basis`
    owner; host clock by part, ending in a synchronise."""
    from npe_tpu_torch.training.eval_grids import sample_and_interp_grid
    from npe_tpu_torch.training.evaluate import validation_pixel_accuracy
    from npe_tpu_torch.training.quality import encoder_fid

    marks = [time.perf_counter()]
    current.load(variables)
    sample_and_interp_grid(module, variables, valid, png, seed=5, programs=current)
    marks.append(time.perf_counter())
    ev = validation_pixel_accuracy(module, variables, valid, module.cfg, max_chunks=1, programs=current)
    marks.append(time.perf_counter())
    fid = encoder_fid(module, variables, real, num=len(real), seed=0, programs=current, feature_programs=basis)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    assert np.isfinite(ev["mse"]) and np.isfinite(fid), (ev, fid)
    parts = {f"{what}_ms": (b - a) * 1e3 for what, a, b in zip(("grid", "validation", "fid"), marks, marks[1:])}
    return dict(parts, checkpoint_ms=(marks[-1] - marks[0]) * 1e3, mse=ev["mse"], encoder_fid=fid)


def time_eval(label, module, variables, smi, valid, tmp):
    """`eval_checkpoint` captured (two owners, as the trainer's) beside eager
    (`eager=True`): the first checkpoint (every program's eager first call and
    capture), then the median of EVAL_TIMED more, by part; each program's
    first call; the peak device memory the two owners add over the first
    checkpoint (two copies of the weights, the graphs' pool, the
    workspaces)."""
    from npe_tpu_torch.data import data_loader
    from npe_tpu_torch.training.programs import EvalPrograms

    fid_bs = min(module.cfg["batch_size"], EVAL_FID_IMAGES)
    real = next(iter(data_loader(dict(module.cfg, batch_size=fid_bs, batches_per_chunk=EVAL_FID_IMAGES // fid_bs),
                                 valid, offset=0)))
    out = {}
    for path in ("captured", "eager"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        current, basis = (EvalPrograms(module, "cuda", eager=path == "eager") for _ in range(2))
        basis.load(variables)
        args = (module, variables, valid, real, current, basis, os.path.join(tmp, f"{path}.png"))
        first = eval_checkpoint(*args)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        timed = [eval_checkpoint(*args) for _ in range(EVAL_TIMED)]
        res = {k: float(np.median([t[k] for t in timed])) for k in ("grid_ms", "validation_ms", "fid_ms",
                                                                     "checkpoint_ms")}
        res.update(first_checkpoint_ms=first["checkpoint_ms"], peak_mib=peak, mse=first["mse"],
                   encoder_fid=first["encoder_fid"], signatures=current.programs.first_calls + basis.programs.first_calls,
                   first_calls_ms={**first_calls_of(current.programs),
                                   **{f"basis {k}": v for k, v in first_calls_of(basis.programs).items()}})
        out[path] = res
        del current, basis, args
    c, e = out["captured"], out["eager"]
    log(f"[time] {label} one checkpoint's evaluation (grid, validation max_chunks=1 at batch "
        f"{module.cfg['batch_size']}, encoder-FID over {len(real)}), captured / eager: {c['checkpoint_ms']:.2f} / "
        f"{e['checkpoint_ms']:.2f} ms (grid {c['grid_ms']:.2f} / {e['grid_ms']:.2f}, validation "
        f"{c['validation_ms']:.2f} / {e['validation_ms']:.2f}, FID {c['fid_ms']:.2f} / {e['fid_ms']:.2f}); first "
        f"checkpoint {c['first_checkpoint_ms']:.1f} / {e['first_checkpoint_ms']:.1f} ms; peak device memory the two "
        f"owners add {c['peak_mib']:.1f} / {e['peak_mib']:.1f} MiB; mse {c['mse']:.6f} / {e['mse']:.6f}, "
        f"encoder_fid {c['encoder_fid']:.4f} / {e['encoder_fid']:.4f} ({smi})")
    log(f"[time] {label} evaluation programs' first calls, captured (the eager call and the capture), ms: "
        f"{ {k: round(v, 1) for k, v in c['first_calls_ms'].items()} }")
    return out


def drive_evaluation(variables, counters, smi):
    """The [eval] phase: `drive_eval` for IAN_simple, IANv1 (hybrid head) and
    full IAN (per-op MDBLOCKs), the trainer's forms, at full width, float32,
    on the phase's unit-gain weights and a second seeded set; then
    `time_eval` for each. Returns (the checks' launches, summed; the times)."""
    from npe_tpu_torch.data.datasets import NpzImageDataset, SyntheticFaces
    from npe_tpu_torch.models import get_config

    launches = {name: 0 for name in counters.forms}
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        # train()'s validation set in memory, as a user's validation .npz
        path = os.path.join(tmp, "valid.npz")
        np.savez(path, SyntheticFaces(EVAL_VALID_EXAMPLES).get_data(np.arange(EVAL_VALID_EXAMPLES)).astype(np.uint8))
        valid = NpzImageDataset(path)
        for label, config, tail in (("IAN_simple", "IAN_simple", False), ("IANv1 hybrid head", "IANv1", True),
                                    ("IAN per-op MDBLOCKs", "IAN", True)):
            module = get_config(config)
            got = drive_eval(label, module, variables[config], seeded_variables(module, 1), counters, tail)
            launches = {name: n + got[name] for name, n in launches.items()}
            times[label] = time_eval(label, module, variables[config], smi, valid, tmp)
    return launches, times


# --- serving: InferenceServer, ModelHost over HTTP, the web editor -----------


def http_json(url, body=None, timeout=SERVE_WAIT):
    """GET (body None) or POST a JSON body; the decoded JSON answer."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms, and PyTorch's deterministic forms of
    the operations that otherwise add with atomics in another order on every
    run (`torch.use_deterministic_algorithms`, warning where an operation
    has none): without them the card's float32 training step does not repeat
    itself, and Adam's sign-like steps carry the last bits into the weights.
    For comparing two training paths step by step."""
    old = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with cudnn_deterministic():
            yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's default algorithms for a deconv (a convolution's backward-data
    pass) may add with atomics, so two runs of one decode can differ in the
    last bits: the exact comparisons of two paths run with deterministic
    algorithms. The flag is global, so it reaches the servers' threads."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def start_http(httpd):
    """serve_forever on a thread of its own; returns (base url, stop)."""
    import threading

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        assert not thread.is_alive(), "the HTTP thread did not stop"

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def count_group_calls(server):
    """Count the server's model calls by op: each runs one group part of at
    most max_batch images at its bucket, and launches each kernel of its path
    once. `calls["buckets"][op]` gathers the buckets the calls ran at."""
    calls = {"encode": 0, "decode": 0, "buckets": {"encode": set(), "decode": set()}}
    for op, fn in list(server._kernels.items()):
        def counted(x, op=op, fn=fn):
            calls[op] += 1
            calls["buckets"][op].add(server.bucket(len(x)))
            return fn(x)
        server._kernels[op] = counted
    return calls


def buckets_of(server, op):
    """{bucket: captures} of the server's programs of `op`."""
    return {key[1][0][0][0]: n for key, n in server.programs.captures(op).items()}


def first_calls_of(programs):
    """{"name batch": ms} of each signature's first call (on the card the
    eager call and the capture, upload and download included)."""
    return {f"{key[0]} {key[1][0][0][0]}": sig.first_call_ms for key, sig in programs.signatures.items()}


def served_script(server, x_nhwc):
    """One sequential request of each of SERVED_SIZES, each its own group:
    encodes, then decodes of their latents. Returns every result."""
    zs = [server.encode(x_nhwc[:n]).result(timeout=SERVE_WAIT) for n in SERVED_SIZES]
    return zs + [server.decode(z).result(timeout=SERVE_WAIT) for z in zs]


def serve_captured_vs_eager(label, config, variables, inputs, wire, counters, expect, dtype=None, **forms):
    """The served script through a captured server and an eager one
    (`eager=True`) on the same weights, under deterministic algorithms: the
    captured server runs it twice, the first run making a program for each
    bucket it reaches (an eager call and a capture each), the second, on
    other images, all replays, under the profiler, with the counts set to 0 just before and
    read just after, held to the device kernels it recorded and to `expect`
    ({name: (op whose calls launch it, launches a call)}); every result of
    both runs equal to the eager server's bit for bit; the captured server's
    programs one capture for each bucket, the eager one's none. Returns the
    replayed script's launches."""
    from npe_tpu_torch.serving import InferenceServer

    outs, caps = {}, {}
    with deterministic_algorithms():
        for path in ("captured", "eager"):
            server = InferenceServer(config, variables=variables, max_batch=SERVE_MAX_BATCH, wire=wire,
                                     device="cuda", dtype=dtype, eager=path == "eager", **forms)
            try:
                outs[path] = served_script(server, inputs)
                if path == "captured":
                    calls = count_group_calls(server)
                    counters.zero()
                    outs["replayed"], seen = profiled(lambda: served_script(server, inputs[::-1]))  # noqa: B023
                    launches = counters.read()
                else:
                    outs["eager, other images"] = served_script(server, inputs[::-1])
                caps[path] = {op: buckets_of(server, op) for op in ("encode", "decode")}
            finally:
                server.close()
    for run, twin in (("captured", "eager"), ("replayed", "eager, other images")):
        for i, (g, w) in enumerate(zip(outs[run], outs[twin])):
            what = f"{'encode' if i < len(SERVED_SIZES) else 'decode'} of {SERVED_SIZES[i % len(SERVED_SIZES)]}"
            assert g.dtype == np.float32 and np.isfinite(g).all(), f"{label}: served {what} is not finite float32"
            assert np.array_equal(g, w), f"{label}: served {what} ({run}), captured vs eager, differs by " \
                                         f"{max_err(g, w)}"
    check_witnessed(f"{label} served script, replayed", launches, seen)
    for name, n in launches.items():
        want = calls[expect[name][0]] * expect[name][1] if name in expect else 0
        assert n == want, f"{label} served script: {name} launched {n} times, not {want}"
    assert caps["captured"] == {op: dict.fromkeys(SERVED_BUCKETS, 1) for op in caps["captured"]}, caps
    assert caps["eager"] == {op: dict.fromkeys(SERVED_BUCKETS, 0) for op in caps["eager"]}, caps
    log(f"[serve] {label}: captured server vs eager, requests of {SERVED_SIZES} images, every result equal bit "
        f"for bit under deterministic algorithms; one capture a bucket and op, {caps['captured']['encode']}; "
        f"launches {launches}")
    return launches


def serve_requests(server, x_nhwc):
    """The serving path of one server: 64 concurrent 1-image requests per
    op, one 20-image request per op over max_batch 16 (split in two), and
    an alternating encode/decode burst whose futures must finish in order.
    Every future's result is read. Returns the encodes' and decodes'
    results, the decode inputs (the served encodes) and the burst's."""
    n = SERVE_REQUESTS
    z = np.concatenate([f.result(timeout=SERVE_WAIT) for f in [server.encode(x_nhwc[i:i + 1]) for i in range(n)]])
    y = np.concatenate([f.result(timeout=SERVE_WAIT) for f in [server.decode(z[i:i + 1]) for i in range(n)]])
    z20 = server.encode(x_nhwc[:20]).result(timeout=SERVE_WAIT)
    y20 = server.decode(z[:20]).result(timeout=SERVE_WAIT)
    done, burst = [], []
    for i in range(8):
        fut = server.decode(z[i:i + 1]) if i % 2 else server.encode(x_nhwc[i:i + 1])
        fut.add_done_callback(lambda _, i=i: done.append(i))
        burst.append(fut)
    burst = [f.result(timeout=SERVE_WAIT) for f in burst]
    assert done == list(range(8)), f"the burst finished out of order: {done}"
    return {"z": z, "y": y, "z20": z20, "y20": y20, "burst_z": np.concatenate(burst[0::2]),
            "burst_y": np.concatenate(burst[1::2])}


def check_served(label, out, ian, x_nhwc, wire):
    """The served results against api.IAN's direct calls on the card, on
    the same inputs and weights (NCHW there): the golden tolerance; under
    the uint8 wire, a decode within one uint8 step of the float32 decode
    (check_recon_close against it quantised)."""
    from npe_tpu_torch.utils.ranges import from_tanh, to_tanh

    nchw = lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2))  # noqa: E731
    nhwc = lambda a: a.transpose(0, 2, 3, 1)  # noqa: E731
    check_close(f"{label}: 64 served encodes vs api.IAN", out["z"], ian.encode_images(nchw(x_nhwc)))
    check_close(f"{label}: 20-image encode, split at 16, vs api.IAN", out["z20"], ian.encode_images(nchw(x_nhwc[:20])))
    check_close(f"{label}: burst encodes vs api.IAN", out["burst_z"], ian.encode_images(nchw(x_nhwc[0:8:2])))
    decodes = (("64 served decodes", out["y"], out["z"]), ("20-image decode, split at 16", out["y20"], out["z"][:20]),
               ("burst decodes", out["burst_y"], out["z"][1:8:2]))
    for what, got, z in decodes:
        want = nhwc(ian.sample_at(z))
        assert np.isfinite(got).all() and got.shape == want.shape
        if wire == "float32":
            check_close(f"{label}: {what} vs api.IAN", got, want)
        else:
            check_recon_close(f"{label}: {what} vs api.IAN quantised to uint8",
                              got, to_tanh(np.clip(np.round(from_tanh(want)), 0, 255)))
            assert max_err(got, want) <= UINT8_STEP + 1e-6, f"{label}: {what} over one uint8 step"


def serve_case(label, server, counters, expect, inputs, total):
    """`serve_requests` on one server with the counts set to 0 just before
    and read just after: each kernel of `expect` ({name: (op whose calls
    launch it, launches a call)}) launched that many times a model call, every
    other none; one capture for each bucket the groups reached. Adds the
    launches into `total`; returns the results."""
    calls = count_group_calls(server)
    counters.zero()
    t0 = time.perf_counter()
    out = serve_requests(server, inputs)
    torch.cuda.synchronize()
    launches = counters.read()
    log(f"[serve] {label}: {2 * SERVE_REQUESTS + 2 + 8} requests in {time.perf_counter() - t0:.3f} s, "
        f"{server.stats['batches']} groups, model calls {calls}; launches {launches}")
    for op in ("encode", "decode"):
        caps = buckets_of(server, op)
        assert caps == dict.fromkeys(calls["buckets"][op], 1), f"{label}: {op} captures {caps}, buckets {calls}"
    for name, n in launches.items():
        want = calls[expect[name][0]] * expect[name][1] if name in expect else 0
        assert n == want, f"{label}: {name} launched {n} times, not {want}"
        total[name] += n
    assert all(launches[name] > 0 for name in expect)
    assert server.stats["errors"] == 0 and server.stats["timeouts"] == 0, server.stats
    return out


def drive_serving_bf16(variables, counters, smi, seed=18):
    """bf16 InferenceServers on the card (IAN_simple on either wire, the uint8
    one through the float32 `staging` kernel and a cast after it; IANv1 with
    the fused head; full IAN with the fused MDBLOCKs and the hybrid head),
    each through `serve_case`, its results held against the float32 api.IAN
    within npe_tpu's bf16 bounds, then one run of bench_torch_serving.py's
    single-request times. Returns (launches summed over the cases, times)."""
    import bench_torch_serving as bench
    from npe_tpu_torch.api import IAN
    from npe_tpu_torch.serving import InferenceServer
    from npe_tpu_torch.utils.ranges import to_tanh

    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (SERVE_REQUESTS, 64, 64, 3)).astype(np.float32)
    x_grid = to_tanh(np.float32(rng.randint(0, 256, x.shape)))
    cases = (("IAN_simple bf16, float32 wire", "IAN_simple", "float32", {}, {}),
             ("IAN_simple bf16, uint8 wire", "IAN_simple", "uint8", {}, {"staging": ("encode", 1)}),
             ("IANv1 bf16, fused head", "IANv1", "float32", {"head_mode": "fused"},
              {"rgb_beta_head_bf16": ("decode", 1)}),
             ("IAN bf16, fused MDBLOCKs", "IAN", "float32", {"mdblock_mode": "fused"},
              {"mdblock_bf16": ("decode", 3), "rgb_beta_tail_bf16": ("decode", 1)}))
    total = {name: 0 for name in counters.forms}
    times = {}
    served_forms(variables, counters, x, x_grid, total, torch.bfloat16)
    for label, config, wire, forms, expect in cases:
        inputs = x_grid if wire == "uint8" else x
        server, base = new_server(config, variables[config], wire, torch.bfloat16, forms)
        try:
            assert all(t.dtype == torch.bfloat16 for t in server.variables.values())
            out = serve_case(label, server, counters, expect, inputs, total)
            ian32 = IAN(config, variables=variables[config], device="cuda", **forms)
            nchw = np.ascontiguousarray(inputs.transpose(0, 3, 1, 2))
            assert all(a.dtype == np.float32 for a in out.values())
            mean_close(f"{label}: 64 served encodes vs float32 api.IAN", out["z"], ian32.encode_images(nchw), Z_BOUND)
            mean_close(f"{label}: 64 served decodes vs float32 api.IAN", out["y"],
                       ian32.sample_at(out["z"]).transpose(0, 2, 3, 1), IMAGE_BOUND)
            mean_close(f"{label}: 20-image decode, split at 16, vs float32 api.IAN", out["y20"],
                       ian32.sample_at(out["z"][:20]).transpose(0, 2, 3, 1), IMAGE_BOUND)
            times[label] = t = bench.measure(server, SERVE_TIMED, 0)
            log(f"[serve] {label} times, one run: encode p50 {t['encode_p50_ms']:.4f} / p95 {t['encode_p95_ms']:.4f} "
                f"ms, decode p50 {t['decode_p50_ms']:.4f} / p95 {t['decode_p95_ms']:.4f} ms ({SERVE_TIMED} "
                f"sequential 1-image requests each) ({smi})")
            t.update(server_memory(server, base))
        finally:
            server.close()
        t.update(time_eager_server(label, config, variables[config], wire, torch.bfloat16, forms, smi))
    return total, times


# every model and form a server runs: (label, config, forms, {kernel: (op, launches a call)}) in float32
SERVED_FORMS = (("IAN_simple", "IAN_simple", {}, {}),
                ("IANv1 hybrid head", "IANv1", {"head_mode": "hybrid"}, {"rgb_beta_tail": ("decode", 1)}),
                ("IANv1 fused head", "IANv1", {"head_mode": "fused"}, {"rgb_beta_head": ("decode", 1)}),
                ("IAN per-op MDBLOCKs", "IAN", {"mdblock_mode": "plain"}, {"rgb_beta_tail": ("decode", 1)}),
                ("IAN fused MDBLOCKs", "IAN", {"mdblock_mode": "fused"},
                 {"mdblock": ("decode", 3), "rgb_beta_tail": ("decode", 1)}))


def served_forms(variables, counters, x, x_grid, total, dtype=None):
    """`serve_captured_vs_eager` for every model and form on both wires in
    `dtype`: the uint8 wire's encode launches the (float32) staging kernel
    once a call, the decode's kernels take the dtype's form. Adds the
    replayed scripts' launches into `total`."""
    suffix = "_bf16" if dtype is not None else ""
    for label, config, forms, expect in SERVED_FORMS:
        for wire, inputs in (("float32", x), ("uint8", x_grid)):
            want = {name + suffix: v for name, v in expect.items()}
            if wire == "uint8":
                want["staging"] = ("encode", 1)
            launches = serve_captured_vs_eager(f"{label}{' bf16' if dtype else ''}, {wire} wire", config,
                                               variables[config], inputs, wire, counters, want, dtype, **forms)
            for name, n in launches.items():
                total[name] += n


def new_server(config, variables, wire, dtype, forms, eager=False):
    """An InferenceServer on the card at SERVE_MAX_BATCH, and the device
    memory allocated before it (the peak counter reset)."""
    from npe_tpu_torch.serving import InferenceServer

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return InferenceServer(config, variables=variables, max_batch=SERVE_MAX_BATCH, wire=wire, device="cuda",
                           dtype=dtype, eager=eager, **forms), base


def server_memory(server, base):
    """The peak device memory a server added above `base`, and its programs'
    first calls."""
    torch.cuda.synchronize()
    return {"peak_mb": (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
            "first_call_ms": first_calls_of(server.programs)}


def time_eager_server(label, config, variables, wire, dtype, forms, smi):
    """One run of bench_torch_serving.py's single-request times on an eager
    twin of a server (`eager=True`): {"eager": its figures and peak memory}."""
    import bench_torch_serving as bench

    server, base = new_server(config, variables, wire, dtype, forms, eager=True)
    try:
        t = bench.measure(server, SERVE_TIMED, 0)
        t.update(server_memory(server, base))
    finally:
        server.close()
    log(f"[serve] {label} eager twin, one run: encode p50 {t['encode_p50_ms']:.4f} / p95 {t['encode_p95_ms']:.4f} ms, "
        f"decode p50 {t['decode_p50_ms']:.4f} / p95 {t['decode_p95_ms']:.4f} ms; peak device memory "
        f"{t['peak_mb']:.1f} MiB ({smi})")
    return {"eager": t}


def drive_serving(variables, counters, smi, seed=17):
    """Five InferenceServers on the card (IAN_simple with either wire, IANv1
    with the head in either kernel form, full IAN with the fused MDBLOCKs),
    each driven through `serve_requests` with the counts set to 0 just
    before and read just after, held against api.IAN, then timed with
    bench_torch_serving.py's functions; then a ModelHost of the three models
    over HTTP. Returns (launches summed over the cases, times)."""
    import bench_torch_serving as bench
    from npe_tpu_torch.api import IAN
    from npe_tpu_torch.serving import InferenceServer
    from npe_tpu_torch.utils.ranges import to_tanh

    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (SERVE_REQUESTS, 64, 64, 3)).astype(np.float32)
    x_grid = to_tanh(np.float32(rng.randint(0, 256, x.shape)))  # on the uint8 grid
    # (label, config, wire, forms, {kernel: (op whose calls launch it, launches a call)})
    cases = (("IAN_simple float32 wire", "IAN_simple", "float32", {}, {}),
             ("IAN_simple uint8 wire", "IAN_simple", "uint8", {}, {"staging": ("encode", 1)}),
             ("IANv1 hybrid head", "IANv1", "float32", {"head_mode": "hybrid"}, {"rgb_beta_tail": ("decode", 1)}),
             ("IANv1 fused head", "IANv1", "float32", {"head_mode": "fused"}, {"rgb_beta_head": ("decode", 1)}),
             ("IAN fused MDBLOCKs", "IAN", "float32", {"mdblock_mode": "fused"},
              {"mdblock": ("decode", 3), "rgb_beta_tail": ("decode", 1)}))
    total = {name: 0 for name in counters.forms}
    times = {}
    served_forms(variables, counters, x, x_grid, total)
    for label, config, wire, forms, expect in cases:
        inputs = x_grid if wire == "uint8" else x
        server, base = new_server(config, variables[config], wire, None, forms)
        try:
            out = serve_case(label, server, counters, expect, inputs, total)
            check_served(label, out, IAN(config, variables=variables[config], device="cuda", **forms), inputs, wire)
            runs = [bench.measure(server, SERVE_TIMED, SERVE_LOAD) for _ in range(SERVE_REPEATS)]
            times[label] = bench.median_of(runs)
            t = times[label]
            log(f"[serve] {label} times, median of {SERVE_REPEATS} runs: encode p50 {t['encode_p50_ms']:.4f} / "
                f"p95 {t['encode_p95_ms']:.4f} ms, decode p50 {t['decode_p50_ms']:.4f} / p95 "
                f"{t['decode_p95_ms']:.4f} ms ({SERVE_TIMED} sequential 1-image requests each); {SERVE_LOAD} "
                f"concurrent 1-image encodes {t['load_req_per_s']:.1f} req/s in groups of {t['load_mean_group']:.2f} "
                f"on average; EMA of a group encode "
                f"{t['encode_ema_ms']:.4f} / decode {t['decode_ema_ms']:.4f} ms; transport floor p50 "
                f"{t['transport_floor_p50_ms']:.4f} ms ({smi})")
            t.update(server_memory(server, base))
            log(f"[serve] {label}: peak device memory {t['peak_mb']:.1f} MiB; first calls, ms: {t['first_call_ms']}")
        finally:
            server.close()
        t.update(time_eager_server(label, config, variables[config], wire, None, forms, smi))

    # three models in one process over HTTP: the answers equal the direct calls
    with cudnn_deterministic():
        check_model_host(variables, x[:2])
    return total, times


def check_model_host(variables, x):
    """A ModelHost of the three models over HTTP on the card: their first
    encodes sent at once, so the three dispatchers run their first calls at
    the same time on three threads, and their captures take turns; /healthz, /models, /stats, encode and decode through
    /<model>/... and the default route equal to the same servers' direct
    answers, a 404 for an unknown model."""
    import urllib.error

    from npe_tpu_torch.serving import InferenceServer, ModelHost, serve_http

    host = ModelHost()
    for config in ("IAN_simple", "IANv1", "IAN"):
        host.add(config, InferenceServer(config, variables=variables[config], max_batch=SERVE_MAX_BATCH,
                                         device="cuda"))
    url, stop = start_http(serve_http(host, port=0))
    try:
        configs = sorted(host.servers)
        with concurrent.futures.ThreadPoolExecutor(len(configs)) as pool:
            firsts = list(pool.map(lambda c: http_json(f"{url}/{c}/encode", {"data": x[:2].tolist()}), configs))
        assert all(np.isfinite(np.asarray(f["result"], np.float32)).all() for f in firsts)
        caps = {c: buckets_of(host.get(c), "encode") for c in configs}
        assert caps == {c: {2: 1} for c in configs}, caps
        log(f"[serve] HTTP: the three models' first encodes at once on three dispatcher threads, captured: {caps}")
        assert http_json(url + "/healthz") == {"ok": True}
        assert http_json(url + "/models") == {"models": sorted(host.servers), "default": "IAN_simple"}
        for config, route in (("IAN_simple", ""), ("IAN_simple", "/IAN_simple"), ("IANv1", "/IANv1"),
                              ("IAN", "/IAN")):
            direct = host.get(config)
            z = np.asarray(http_json(f"{url}{route}/encode", {"data": x[:2].tolist()})["result"], np.float32)
            want = direct.encode(x[:2]).result(timeout=SERVE_WAIT)
            assert np.array_equal(z, want), f"{route}/encode: max abs diff {max_err(z, want):.3e}"
            y = np.asarray(http_json(f"{url}{route}/decode", {"data": z.tolist()})["result"], np.float32)
            assert y.shape == (2, 64, 64, 3) and np.isfinite(y).all()
            want = direct.decode(z).result(timeout=SERVE_WAIT)
            assert np.array_equal(y, want), f"{route}/decode: max abs diff {max_err(y, want):.3e}"
            log(f"[serve] HTTP {route or '(default)'}/encode and /decode: equal to {config}'s direct answers")
        try:
            http_json(url + "/nope/decode", {"data": x[:1].tolist()})
        except urllib.error.HTTPError as exc:
            assert exc.code == 404, exc
        else:
            raise AssertionError("an unknown model was served")
        stats = http_json(url + "/stats")
        assert sorted(stats) == sorted(host.servers) and all(
            s["requests"] >= 4 and s["errors"] == 0 for s in stats.values()), stats
        log(f"[serve] HTTP /healthz, /models, /stats ({ {k: v['requests'] for k, v in stats.items()} } requests) "
            f"and a 404 for an unknown model")
    finally:
        stop()
        host.close()


def drive_web(variables, counters, smi, index=7):
    """The web editor over HTTP on the card: /infer, the 16-stroke script as
    /paint calls (the captured stroke, its capture made on a handler
    thread), /undo and a /session fork, held exactly against an EditSession
    on the card that runs the same script directly; edit_tail launches once a
    stroke. Then /paint's p50 over HTTP. Returns (launches, times)."""
    from http.server import ThreadingHTTPServer

    from npe_tpu_torch.editor.engine import EditSession
    from npe_tpu_torch.editor.web import EditorService, make_handler

    service = EditorService(EditSession("IAN_simple", variables=variables, device="cuda"))
    url, stop = start_http(ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service)))
    try:
        with cudnn_deterministic():
            launches = check_web_script(url, variables, counters, index)
        # /paint over HTTP, and where its time goes: the same route through
        # EditorService.handle (the stroke, two PNGs) on this thread, then on
        # a new thread each, as the HTTP server runs it
        strokes = stroke_script()
        ways = {"http": lambda body: http_json(url + "/paint", body),
                "handle": lambda body: service.handle("/paint", body),
                "handle on a new thread": lambda body: on_new_thread(lambda: service.handle("/paint", body))}
        times = {}
        for way, call in ways.items():
            ms = []
            for i in range(SERVE_TIMED):
                t0 = time.perf_counter()
                call(paint_body(strokes[i % N_STROKES]))
                ms.append((time.perf_counter() - t0) * 1e3)
            times[way] = [float(v) for v in np.percentile(ms, [50, 95])]
            log(f"[serve] web editor /paint, {way}, IAN_simple, {SERVE_TIMED} strokes: p50 {times[way][0]:.4f} ms, "
                f"p95 {times[way][1]:.4f} ms ({smi})")
    finally:
        stop()
    return launches, {"paint_http_p50_ms": times["http"][0], "paint_http_p95_ms": times["http"][1],
                      "paint_handle_p50_ms": times["handle"][0],
                      "paint_handle_new_thread_p50_ms": times["handle on a new thread"][0]}


def on_new_thread(fn):
    import threading

    out = []
    thread = threading.Thread(target=lambda: out.append(fn()))
    thread.start()
    thread.join(timeout=SERVE_WAIT)
    assert out, "the call on a new thread did not return"
    return out[0]


def paint_body(stroke):
    x1, y1, x2, y2, rgb, sigma = stroke
    return {"x1": x1, "y1": y1, "x2": x2, "y2": y2, "rgb": list(rgb), "sigma": sigma}


def check_web_script(url, variables, counters, index):
    """/infer, the stroke script as /paint calls and /undo under the
    profiler, with the counts set to 0 just before and read just after and
    held against the device kernels it recorded; the latents and the photo
    against a direct session's, exactly; then a /session fork."""
    import base64

    from npe_tpu_torch.data import SyntheticFaces
    from npe_tpu_torch.editor.engine import EditSession
    from npe_tpu_torch.utils.png import decode_rgb
    from npe_tpu_torch.utils.ranges import to_tanh

    def script():
        http_json(url + "/infer", {"index": index})
        for stroke in stroke_script():
            http_json(url + "/paint", paint_body(stroke))
        return http_json(url + "/undo", {})

    counters.zero()
    st, seen = profiled(script)
    launches = counters.read()
    log(f"[serve] web editor: /infer, {N_STROKES} /paint, /undo over HTTP under the profiler; launches {launches}")
    check_witnessed("web editor", launches, seen)
    assert launches["edit_tail"] == N_STROKES and sum(launches.values()) == N_STROKES, launches

    direct = EditSession("IAN_simple", variables=variables, device="cuda")
    direct.infer(to_tanh(np.float32(SyntheticFaces(num_examples=4096).get_data([index])[0])))
    for stroke in stroke_script():
        direct.paint_stroke(*stroke)
    direct.undo()
    z, photo = np.asarray(st["z"], np.float32), decode_rgb(base64.b64decode(st["photo_png"]))
    want_photo = direct.im_uint8().transpose(1, 2, 0)
    log(f"[serve] web editor vs a direct session: latents max abs diff {max_err(z, direct.Z_grid):.3e}, "
        f"photo pixels that differ {int((photo != want_photo).sum())}")
    assert np.array_equal(z, direct.Z_grid) and np.array_equal(photo, want_photo)
    st = http_json(url + "/session", {"name": "img2"})
    assert st["session"] == "img2" and st["sessions"] == ["img2", "main"] and not np.any(st["z"])
    st = http_json(url + "/session", {"name": "main"})
    assert np.array_equal(np.asarray(st["z"], np.float32), direct.Z_grid)
    log("[serve] web editor: latents and photo equal to the direct session's, exactly; /session forks "
        "a fresh session and keeps main's")
    return launches


# --- phase 8: multi-device training (torch.distributed) ------------------------

DP_TIMEOUT = 240  # seconds any one phase-8 subprocess (or pair) may take
DP_REPEATS = 5  # timed G + D pairs after the checked one
# the D step after a G step, data-parallel vs one process on the card: it
# reads the weights after Adam's first, sign-like step, which rounding moves
# by up to lr wherever a gradient is noise, even between two processes that
# make no collective call; TF32 is off on both sides (the subprocesses take
# --no-tf32), and PERF.md has the readings
DP_D_RTOL, DP_D_ATOL = 2e-2, 2e-3
# Adam's first moments after that pair (mu = (1 - b1) * g: the summed
# gradients), data-parallel vs one process on the card, tensor by tensor in
# norm: |got - want| <= DP_MU_REL * |want| + DP_MU_FLOOR * (the part's largest
# value) * sqrt(size). A gradient summed once too few or too many times is
# off by 50 % or 100 % in every tensor. The card's float32 step does not
# repeat itself: the same one-process G + D pair run twice in one process
# parts by several percent in norm (the D gradients, which read the weights
# after the G step's sign-like Adam step) and by up to a tenth of a tensor's
# largest value in single elements, so an element-wise bound would hold
# rounding, not the sum; this phase logs that yardstick beside each
# comparison, and PERF.md has the readings. The floor passes a gradient that
# is zero in exact arithmetic and comes out as rounding noise (mu_bnorm.beta's)
DP_MU_REL, DP_MU_FLOOR = 0.2, 1e-5


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(label, commands, root, timeout=DP_TIMEOUT):
    """Start the commands (argv lists) together from `root`, wait for all
    within `timeout` seconds; every one must exit 0. Returns their (stdout,
    stderr) and the wall time. At the limit each one left gets SIGABRT, on
    which Python's faulthandler prints every thread's stack, then is killed,
    and its output is logged."""
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""), PYTHONFAULTHANDLER="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in commands]
    outs = [None] * len(procs)
    try:
        for i, proc in enumerate(procs):
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                outs[i] = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                break
    finally:
        for i, proc in enumerate(procs):
            if proc.poll() is None:
                proc.send_signal(signal.SIGABRT)
                try:
                    outs[i] = proc.communicate(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    outs[i] = proc.communicate()
    wall = time.perf_counter() - t0
    for c, proc, (out, err) in zip(commands, procs, outs):
        if proc.returncode != 0:
            log(out[-4000:])
            log(err[-8000:])
    for c, proc in zip(commands, procs):
        if proc.returncode != 0:
            raise AssertionError(f"{label}: {' '.join(c)} exited {proc.returncode} after {wall:.1f} s (limit {timeout} s)")
    return outs, wall


def tagged(lines, tag):
    return [json.loads(line[len(tag) + 1:]) for line in lines.splitlines() if line.startswith(tag + " ")]


def multihost_cmd(port, n, i, *extra):
    return [sys.executable, "-m", "npe_tpu_torch.parallel.multihost", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(n), "--process-id", str(i), "--device", "cuda", "--repeats", str(DP_REPEATS),
            "--timeout", str(DP_TIMEOUT), "--no-tf32", *extra]


def check_moments(label, got, want):
    """Every Adam first moment of the data-parallel state against one
    process's, by DP_MU_REL / DP_MU_FLOOR. Returns, over the tensors above
    the floor, the worst |got - want| / |want| and the worst element's
    |got - want| over its tensor's largest value, each with its tensor."""
    worst = worst_elt = (0.0, "none")
    assert sorted(got) == sorted(want), (label, sorted(got))
    for part, mu in want.items():
        assert sorted(got[part]) == sorted(mu), (label, part)
        scale = max(float(t.abs().max()) for t in mu.values())
        for k, w in mu.items():
            g = got[part][k].float()
            assert g.shape == w.shape and torch.isfinite(g).all(), (label, part, k)
            err, norm, floor = float((g - w).norm()), float(w.norm()), DP_MU_FLOOR * scale * w.numel() ** 0.5
            assert err <= DP_MU_REL * norm + floor, (f"{label} mu {part}/{k}: |got - want| {err:.3e} over "
                                                     f"{DP_MU_REL} * |want| {norm:.3e} + {floor:.3e}")
            if norm > floor:
                worst = max(worst, (err / norm, f"{part}/{k}"), key=lambda t: t[0])
                worst_elt = max(worst_elt, (float((g - w).abs().max() / w.abs().max()), f"{part}/{k}"),
                                key=lambda t: t[0])
    return worst, worst_elt


def moment_spread(label, got, want):
    return "worst |got - want| / |want| {:.3e} ({}), worst element {:.3e} of its tensor's largest ({})".format(
        *(x for pair in check_moments(label, got, want) for x in pair))


def check_demo(label, got, want, ranks, mu, expect):
    """A data-parallel G + D step against the card's one-process step on the
    same weights and batch, the ranks' states and this run's kernel launches
    on every rank. The G step's metrics, a forward from the same weights, at
    RTOL / ATOL; the D step's read the weights after the G step, which
    Adam's first, sign-like step (lr * g / (|g| + eps)) moves by up to lr
    wherever a gradient is rounding noise, so they are held to DP_D_RTOL /
    DP_D_ATOL; the gradients themselves through rank 0's Adam first moments
    (`mu`, check_moments), and every rank's whole state, parameters and
    moments, bit for bit the same (its digest). Returns the launches summed
    over the ranks."""
    for player, (rtol, atol) in (("gen", (RTOL, ATOL)), ("discrim", (DP_D_RTOL, DP_D_ATOL))):
        assert all(np.isfinite(v) for v in got[player].values()), got
        for k, w in want[player].items():
            np.testing.assert_allclose(got[player][k], w, rtol=rtol, atol=atol, err_msg=f"{label} {player} {k}")
    spread = moment_spread(label, mu, want["mu"])
    assert len({r["state_sha256"] for r in ranks}) == 1, (label, [r["state_sha256"] for r in ranks])
    for rank in ranks:
        assert rank["launches"] == expect, (label, rank)
    worst = {p: max(abs(got[p][k] - want[p][k]) / (abs(want[p][k]) + 1e-6) for k in want[p])
             for p in ("gen", "discrim")}
    log(f"[dp] {label}: G metrics within rtol {RTOL} / atol {ATOL}, D metrics within rtol {DP_D_RTOL} / atol "
        f"{DP_D_ATOL} of one process's (worst relative diff G {worst['gen']:.3e}, D {worst['discrim']:.3e}); "
        f"Adam's mu within {DP_MU_REL} of each tensor's norm + {DP_MU_FLOOR} of its part's largest ({spread}); "
        f"{len(ranks)} rank(s) with state digest "
        f"{ranks[0]['state_sha256'][:16]}; launches per rank {[r['launches'] for r in ranks]}")
    return {name: sum(r["launches"][name] for r in ranks) for name in expect}


def block_case(name, device):
    """A library block at small widths on seeded weights and input (drawn on
    the CPU), run on `device`."""
    from npe_tpu_torch.models.common import VarBuilder
    from npe_tpu_torch.ops import blocks, norm

    gen = torch.Generator().manual_seed(3)
    vb = VarBuilder(gen, "cpu")
    x = torch.randn((4, 32, 16, 16), generator=gen).to(device)
    scales = [0, 2, 3]
    if name == "USL":
        blocks.usl_init(vb, "usl", 32, 16, scales)
        return blocks.usl_apply({k: t.to(device) for k, t in vb.v.items()}, "usl", x, scales)
    if name == "DSL":
        blocks.dsl_init(vb, "dsl", 32, 16, scales)
        return blocks.dsl_apply({k: t.to(device) for k, t in vb.v.items()}, "dsl", x, scales)
    if name == "inception":
        dicts = [blocks.pd(num_layers=2, num_filters=16, bnorm=1),
                 blocks.pd(num_layers=1, num_filters=8, filter_size=1, pad=0, bnorm=0),
                 blocks.pd(num_layers=1, num_filters=8, filter_size=3, style="pool", mode="max", bnorm=0),
                 blocks.pd(num_layers=1, num_filters=8, filter_size=3, style="pool", bnorm=0),
                 blocks.pd(num_layers=1, num_filters=8, filter_size=3, style="dilation", dilation=2, bnorm=0)]
        blocks.inception_init(vb, "inc", 32, dicts)
        return blocks.inception_apply({k: t.to(device) for k, t in vb.v.items()}, {}, "inc", x, dicts, train=True)
    vb.bn("rn", 32)
    v = {k: t.to(device) for k, t in vb.v.items()}
    return norm.batch_renorm_apply(x, v["rn.beta"], v["rn.gamma"], v["rn.mean"] + 0.2, v["rn.inv_std"] * 1.5,
                                   *norm.renorm_schedule(3000), True)[0]


def drive_data_parallel(root, smi):
    """Phase 8: the port's multi-device path in subprocesses, each group
    with its own time limit. (a) one rank over NCCL, mesh (1, 1); (b) two
    ranks sharing the card over gloo, mesh (2, 1); (c) from (b)'s ranks,
    mesh (1, 2) encode + decode with the 'model' weights in halves; (d) the
    trainer under torchrun with --data-parallel; (e) the library blocks.
    Returns (the launches of staging and rgb_beta_tail on these paths, the
    readings)."""
    from npe_tpu_torch.api import IAN
    from npe_tpu_torch.models import ian_simple
    from npe_tpu_torch.parallel import multihost

    dp = {name: 0 for name in ("staging", "rgb_beta_tail")}

    def count(launches):
        for name, n in launches.items():
            dp[name] += n

    readings = {}
    out_dir = tempfile.mkdtemp()
    steps = (("IAN_simple", TRAIN_BATCH), ("IANv1", 16))
    # the card's one-process steps on the same weights and batch, timed alike
    single = {c: multihost.run_demo(None, b, c, repeats=DP_REPEATS) for c, b in steps}
    # the yardstick of the moments' rule: the same one-process pair again, in this process
    for c, b in steps:
        again = multihost.run_demo(None, b, c)["mu"]
        log(f"[dp] {c} batch {b}, one process's G + D pair twice in one process: Adam's mu "
            f"{moment_spread(c + ' twice', again, single[c]['mu'])}")
    torch.cuda.synchronize()

    def moments(where, config):
        return torch.load(os.path.join(out_dir, where, f"mu_{config}.pt"))

    # (a) one rank over NCCL, mesh (1, 1)
    (outs,), wall = run_procs("(a)", [multihost_cmd(free_port(), 1, 0, "--config", "IAN_simple", "--batch-size",
                                                    str(TRAIN_BATCH), "--out", os.path.join(out_dir, "a"))], root)
    got = tagged(outs[0], "MULTIHOST_METRICS")[0]
    assert got["backend"] == "nccl" and got["mesh"] == [1, 1], got
    ranks = tagged(outs[0], "MULTIHOST_LAUNCHES")
    assert len(ranks) == 1, ranks
    count(check_demo(f"(a) IAN_simple batch {TRAIN_BATCH}, one rank over NCCL", got, single["IAN_simple"], ranks,
                     moments("a", "IAN_simple"), {"staging": 1, "rgb_beta_tail": 0}))
    one = single["IAN_simple"]["ms_per_g_and_d_step"]
    readings["nccl_world_of_one"] = {"ms_per_g_and_d_step": got["ms_per_g_and_d_step"], "one_process_ms": one,
                                     "process_wall_s": wall}
    log(f"[dp] (a) G + D step at batch {TRAIN_BATCH}: {got['ms_per_g_and_d_step']:.3f} ms under a world of one "
        f"over NCCL, {one:.3f} ms in one process without a process group; the subprocess took {wall:.1f} s ({smi})")

    # (b) two ranks on the card over gloo, mesh (2, 1); (c) then mesh (1, 2)
    port = free_port()
    extra = ["--backend", "gloo", "--config", *[c for c, _ in steps], "--batch-size", *[str(b) for _, b in steps],
             "--infer-mesh", "1", "2", "--out", os.path.join(out_dir, "b")]
    outs, wall = run_procs("(b)", [multihost_cmd(port, 2, i, *extra) for i in range(2)], root)
    metrics = {m["config"]: m for m in tagged(outs[0][0], "MULTIHOST_METRICS")}
    ranks = [r for out, _ in outs for r in tagged(out, "MULTIHOST_LAUNCHES")]
    readings["gloo_two_ranks_one_card"] = {"process_wall_s": wall}
    for c, b in steps:
        got = metrics[c]
        assert got["backend"] == "gloo" and got["mesh"] == [2, 1], got
        expect = {"staging": 1, "rgb_beta_tail": 4 if c == "IANv1" else 0}
        on_c = [r for r in ranks if r["config"] == c]
        assert sorted(r["rank"] for r in on_c) == [0, 1], on_c
        count(check_demo(f"(b) {c} batch {b} ({b // 2} a rank), two ranks sharing the card over gloo", got,
                         single[c], on_c, moments("b", c), expect))
        readings["gloo_two_ranks_one_card"][c] = {"ms_per_g_and_d_step": got["ms_per_g_and_d_step"],
                                                  "one_process_ms": single[c]["ms_per_g_and_d_step"]}
        log(f"[dp] (b) {c} batch {b}: {got['ms_per_g_and_d_step']:.3f} ms per G + D step, two ranks SHARING one card "
            f"over gloo (no multi-card scaling is measured), {single[c]['ms_per_g_and_d_step']:.3f} ms in one process "
            f"({smi})")
    infer = tagged(outs[0][0], "MULTIHOST_INFER")[0]
    assert infer["mesh"] == [1, 2] and {"enc_conv4.W", "dec_conv1.W", "l_dec_fc2.W"} <= set(infer["sharded"]), infer
    with np.load(os.path.join(out_dir, "b", "infer.npz")) as f:
        x, y = f["x"], f["y"]
    shutil.rmtree(out_dir)
    ian = IAN("IAN_simple", variables=ian_simple.init(torch.Generator().manual_seed(0), "cuda"), device="cuda")
    check_close("(c) IAN_simple encode + decode at batch 64, mesh (1, 2) with the 'model' weights in halves, vs "
                "api.IAN", y, ian.sample_at(ian.encode_images(x)))
    log(f"[dp] (c) sharded along 'model': {infer['sharded']}")

    # (d) the trainer under torchrun, one epoch of two chunks
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_port",
               str(free_port()), "-m", "npe_tpu_torch.training.train", "IAN_simple", "--data-parallel",
               "--max-epochs", "1", "--num-examples", str(4 * TRAIN_BATCH + TRAIN_BATCH // 2), "--batch-size",
               str(TRAIN_BATCH), "--batches-per-chunk", "2", "--out-dir", tmp, "--pics-dir", os.path.join(tmp, "pics")]
        ((out, err),), wall = run_procs("(d)", [cmd], root)
        done = [line for line in err.splitlines() if "training done; kernel launches in this process" in line]
        assert len(done) == 1, err[-3000:]
        trainer = {name: int(n) for name, n in re.findall(r"(staging|rgb_beta_tail) (\d+)", done[0])}
        assert trainer == {"staging": 2, "rgb_beta_tail": 0}, done[0]
        recs = read_metrics(os.path.join(tmp, "IAN_simpleMETRICS.jsonl"))
        assert [r["itr"] for r in recs] == [2, 4], recs
        assert all(np.isfinite(v) for r in recs for v in r["metrics"].values()), recs
        for name in ("IAN_simple.npz", "IAN_simple_train_state.npz", "pics/IAN_simple_0.png"):
            assert os.path.isfile(os.path.join(tmp, name)), name
    count(trainer)
    readings["torchrun_trainer_wall_s"] = wall
    log(f"[dp] (d) torchrun --nproc-per-node 1 ... --data-parallel, IAN_simple, 2 chunks of 2 batches of "
        f"{TRAIN_BATCH}: {wall:.1f} s; 2 finite metrics records, checkpoint files, a grid; {done[0].split('| ')[-1]}")

    # (e) the library blocks on the card against the CPU
    for name in ("USL", "DSL", "inception", "batch renorm"):
        check_close(f"(e) {name} card vs cpu", block_case(name, "cuda").cpu().numpy(), block_case(name, "cpu").numpy())
    return dp, readings


def main():
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")

    from npe_tpu_torch.api import IAN
    from npe_tpu_torch.editor.engine import EditSession
    from npe_tpu_torch.models import common, ian, ian_simple, ian_v1
    from npe_tpu_torch.ops.kernels import build
    from npe_tpu_torch.ops.kernels import edit_tail as et
    from npe_tpu_torch.ops.kernels import mdblock as mk
    from npe_tpu_torch.ops.kernels import rgb_beta_head as rh
    from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
    from npe_tpu_torch.ops.kernels import staging
    from npe_tpu_torch.ops.conv import conv2d, space_to_depth
    from npe_tpu_torch.utils.checkpoints import from_reference, save_weights, to_reference, unit_gain
    from npe_tpu_torch.utils.timing import cuda_ms, graph_ms
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "scripts")]  # bench_torch_serving.py; scripts/launch_floor.py
    import launch_floor  # scripts/launch_floor.py: the empty kernel edit_tail is read beside

    log(f"[phase] 1 starts at {time.perf_counter() - started:.1f} s")
    # 1. Device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi name, power.limit: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    log(f"[phase] 2 starts at {time.perf_counter() - started:.1f} s")
    # 2. Build: one nvcc per source, all started together
    names = build.kernel_names()
    assert names == ["edit_tail", "mdblock", "mdblock_bf16", "mdblock_bwd", "rgb_beta_head", "rgb_beta_tail",
                     "staging"], names
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        outputs = list(pool.map(build.build, names))
    log(f"[build] {len(names)} kernels in parallel in {time.perf_counter() - t0:.2f} s")
    for name, out in zip(names, outputs):
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    log(f"[phase] 3 starts at {time.perf_counter() - started:.1f} s")
    # 3. Kernel checks: each kernel vs its plain version on the card
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in ("edit_tail", "rgb_beta_tail", "rgb_beta_head", "mdblock", "mdblock_bwd",
                                    "staging", "rgb_beta_tail_bf16", "rgb_beta_head_bf16", "mdblock_bf16",
                                    "mdblock_bwd_bf16", "rgb_beta_tail_bwd", "rgb_beta_tail_bwd_bf16",
                                    "rgb_beta_head_bwd", "rgb_beta_head_bwd_bf16")}
    for batch in (1, 8):
        for sigma in (0.7, 1.5, 3.0):  # radius 3, 6 and 12: the last wider than a band at batch 1 and 8
            for mask_kind in (None, "zeros", "random", "ones"):
                xh, recon, err, um = edit_tail_inputs(batch, mask_kind, 1, dev)
                got = et.edit_tail(xh, recon, err, um, sigma)
                torch.cuda.synchronize()
                want = et.edit_tail_reference(xh, recon, err, et.blur_matrix(64, sigma, device=dev), um)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                worst["edit_tail"] = max(worst["edit_tail"], e)
                log(f"[kernel] edit_tail batch {batch} sigma {sigma} user_mask {mask_kind}: "
                    f"max abs err {e:.3e} (tol {KERNEL_TOL})")
                assert e <= KERNEL_TOL, f"edit_tail disagrees with its plain version: {e}"

    def check_kernel(name, case, kernel, plain, args, tol, grad_atol_of_largest=False, grad_of=None):
        """Forward, and the gradient of sum(out^2) through the wrapper's
        autograd.Function, against the plain version's on the same inputs.
        `grad_atol_of_largest`: ATOL times each gradient's largest value, for
        gradients that are sums over every pixel and reach several hundred.
        `grad_of`: the indices of the inputs whose gradients are asked for
        (default all)."""
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        e = float((got - want).abs().max())
        worst[name] = max(worst[name], e)
        log(f"[kernel] {name} {case}: max abs err {e:.3e} (tol {tol}), output std {float(want.std()):.3f}")
        assert got.shape == want.shape and e <= tol, f"{name} disagrees with its plain version: {e}"
        wrt = range(len(args)) if grad_of is None else grad_of
        inputs = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
        leaves = [inputs[i] for i in wrt]
        got_g = torch.autograd.grad((kernel(*inputs) ** 2).sum(), leaves)
        want_g = torch.autograd.grad((plain(*inputs) ** 2).sum(), leaves)
        torch.cuda.synchronize()
        for g, w in zip(got_g, want_g):
            atol = ATOL * max(1.0, float(w.abs().max())) if grad_atol_of_largest else ATOL
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=RTOL, atol=atol,
                                       err_msg=f"{name} {case} gradient")
        log(f"[kernel] {name} {case}: gradients of {len(leaves)} inputs within rtol {RTOL}, atol {ATOL}"
            f"{' of the largest' if grad_atol_of_largest else ''}; "
            f"max abs diff {max(max_err(g.cpu(), w.cpu()) for g, w in zip(got_g, want_g)):.3e}")

    for batch in (1, 8, 16):  # one cell row a block at 1 and 8, two at 16
        _, _, trunk, tg, tb = head_inputs(batch, 64, 10 + batch, dev)
        check_kernel("rgb_beta_tail", f"batch {batch}", rt.rgb_beta_tail, rt.rgb_beta_tail_reference,
                     (trunk, tg, tb), KERNEL_TOL)
    head = lambda *a: rh.rgb_beta_head(*a, HEAD_SCALES)  # noqa: E731
    head_plain = lambda *a: rh.rgb_beta_head_reference(*a, HEAD_SCALES)  # noqa: E731
    for batch, channels in ((1, 64), (2, 64), (1, 128)):  # 128: full IAN's head
        x, tr, _, tg, tb = head_inputs(batch, channels, 20 + batch + channels, dev)
        # the trunk alone (its launch and the slice sum) against the plain trunk, then the whole head
        got = rh.trunk_only(x, tr, HEAD_SCALES)
        want = F.pixel_unshuffle(mk._mdcl_taps(x, tr, mk.tap_offsets(HEAD_SCALES)), 4)
        e = float((got - want).abs().max())
        log(f"[kernel] rgb_beta_head trunk alone C {channels} batch {batch}: max abs err {e:.3e} (tol {HEAD_TOL}), "
            f"trunk std {float(want.std()):.3f}")
        assert e <= HEAD_TOL, f"rgb_beta_head's trunk disagrees with its plain version: {e}"
        check_kernel("rgb_beta_head", f"C {channels} batch {batch}", head, head_plain, (x, tr, tg, tb), HEAD_TOL)
    # the RGB-Beta head's backward kernels: the tail's (dtrunk, dtg, dtb) at
    # the stroke's batch, the training step's and a large one; x's gradient
    # of the whole head at IANv1's and full IAN's widths
    for batch in (1, 16, 128):
        worst["rgb_beta_tail_bwd"] = max(worst["rgb_beta_tail_bwd"], check_tail_backward(batch, 150 + batch, dev))
    for batch, channels in ((1, 64), (8, 64), (1, 128)):
        worst["rgb_beta_head_bwd"] = max(worst["rgb_beta_head_bwd"],
                                         check_head_backward(batch, channels, 160 + batch + channels, dev))
    # the MDBLOCK: forward, and the taps' and affines' gradients (the plain
    # VJP); x's gradient through the backward kernels (check_mdblock_backward)
    for _, channels, size, scales in MDBLOCK_SHAPES:
        for batch in (1, 8):
            case = f"{size}x{size}x{channels} scales {list(scales)} batch {batch}"
            args = mdblock_inputs(batch, channels, size, scales, 40 + batch, dev)
            check_kernel("mdblock", case, lambda *a: mk.mdblock_fused(*a, scales),  # noqa: B023
                         lambda *a: mk.mdblock_taps_reference(*a, scales),  # noqa: B023
                         args, MDBLOCK_TOL, grad_atol_of_largest=True, grad_of=(1, 2, 3))
            worst["mdblock_bwd"] = max(worst["mdblock_bwd"], check_mdblock_backward(f"mdblock_bwd {case}", *args,
                                                                                      scales))
    # the backward alone where its plan takes other branches: batch 128 (one slice, no cluster), slices
    # without a cluster (16x16x256 at batch 3: five groups of one), a 4x16 map (patches cut by its edge)
    bwd_cases = [(channels, (size, size), scales, 128) for _, channels, size, scales in MDBLOCK_SHAPES]
    for channels, (h, w), scales, batch in bwd_cases + [(256, (16, 16), (0, 2, 3), 3), (32, (4, 16), (0, 2), 2)]:
        x, t1, t2, aff = mdblock_inputs(batch, channels, int((h * w) ** 0.5), scales, 40 + batch, dev)
        worst["mdblock_bwd"] = max(worst["mdblock_bwd"], check_mdblock_backward(
            f"mdblock_bwd {h}x{w}x{channels} scales {list(scales)} batch {batch}", x.reshape(batch, channels, h, w),
            t1, t2, aff, scales))

    log(f"[phase] 3b starts at {time.perf_counter() - started:.1f} s")
    # 3b. The bf16 forms of the three dtype-generic kernels, each against its
    # bf16 plain version on the same bf16 inputs, compared in bf16
    def check_bf16_kernel(name, case, kernel, plain, args, grad=False, skip_grad=()):
        """Forward and (`grad`) the gradient of sum(out^2) to each bf16 input
        but those of `skip_grad` through the wrapper's autograd.Function (the
        plain version's VJP, in bf16), each within BF16_POINTS steps of the
        plain version's."""
        got = kernel(*args)
        torch.cuda.synchronize()
        worst[name] = max(worst[name], within_steps(f"[kernel] {name} {case}", got, plain(*args)))
        if grad:
            leaves = [a.clone().requires_grad_(a.dtype == torch.bfloat16 and i not in skip_grad)
                      for i, a in enumerate(args)]
            wrt = [a for a in leaves if a.requires_grad]
            got_g = torch.autograd.grad((kernel(*leaves).float() ** 2).sum(), wrt)
            want_g = torch.autograd.grad((plain(*leaves).float() ** 2).sum(), wrt)
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got_g, want_g)):
                within_steps(f"[kernel] {name} {case} gradient {i}", g, w, BF16_POINTS + 1)

    bf16 = lambda tensors: [t.to(torch.bfloat16) for t in tensors]  # noqa: E731
    for batch in (1, 128):
        _, _, trunk, tg, tb = bf16(head_inputs(batch, 64, 60 + batch, dev))
        check_bf16_kernel("rgb_beta_tail_bf16", f"batch {batch}, bf16 trunk", rt.rgb_beta_tail,
                          rt.rgb_beta_tail_reference, (trunk, tg, tb))
        # the fused head's case: a float32 trunk, never rounded (not counted)
        f32_trunk = head_inputs(batch, 64, 60 + batch, dev)[2]
        check_bf16_kernel("rgb_beta_tail_bf16", f"batch {batch}, float32 trunk", rt.tail_only,
                          rt.rgb_beta_tail_reference, (f32_trunk, tg, tb))
    for batch, channels in ((1, 64), (2, 64), (1, 128)):
        x, tr, _, tg, tb = bf16(head_inputs(batch, channels, 70 + batch + channels, dev))
        got = rh.trunk_only(x, tr, HEAD_SCALES)
        want = F.pixel_unshuffle(mk._mdcl_taps(x.float(), tr.float(), mk.tap_offsets(HEAD_SCALES)), 4)
        e = float((got - want).abs().max())
        log(f"[kernel] rgb_beta_head_bf16 trunk alone C {channels} batch {batch}: float32 trunk of bf16 operands, "
            f"max abs err {e:.3e} (tol {HEAD_TOL})")
        assert got.dtype == torch.float32 and e <= HEAD_TOL, f"the bf16 head's trunk disagrees: {e}"
        check_bf16_kernel("rgb_beta_head_bf16", f"C {channels} batch {batch}", head, head_plain, (x, tr, tg, tb),
                          grad=True)
    # the bf16 backward kernels: the tail's over a bf16 trunk (the hybrid
    # head's) and a float32 one (the fused head's), x's gradient of the head
    for batch in (1, 16, 128):
        for trunk_dtype in (torch.bfloat16, torch.float32):
            worst["rgb_beta_tail_bwd_bf16"] = max(worst["rgb_beta_tail_bwd_bf16"], check_tail_backward(
                batch, 170 + batch, dev, torch.bfloat16, trunk_dtype))
    for batch, channels in ((1, 64), (8, 64), (1, 128)):
        worst["rgb_beta_head_bwd_bf16"] = max(worst["rgb_beta_head_bwd_bf16"], check_head_backward(
            batch, channels, 180 + batch + channels, dev, torch.bfloat16))
    # the bf16 MDBLOCK (its own kernel, mdblock_bf16.cu): full IAN's shapes at
    # batch 1, 8 and 128 (one patch a block and slices; two patches a block),
    # an odd batch, a channel count that is not a multiple of its 64-channel
    # chunk, and a 4x16 map (no 8x8 patches: rows mode); x's gradient through
    # the backward kernels in every case, the taps' (the plain version's VJP)
    # where the batch is small
    bf16_cases = [(channels, (size, size), scales, batch) for _, channels, size, scales in MDBLOCK_SHAPES
                  for batch in (1, 8, 128)]
    bf16_cases += [(512, (8, 8), (0, 2), 3), (48, (8, 8), (0, 2), 2), (32, (4, 16), (0, 2), 2)]
    for channels, (h, w), scales, batch in bf16_cases:
        x, t1, t2, aff = mdblock_inputs(batch, channels, int((h * w) ** 0.5), scales, 80 + batch, dev)
        x = x.reshape(batch, channels, h, w)
        plan = mk.bf16_plan(batch, channels, h, w, scales, torch.cuda.get_device_properties(dev).multi_processor_count)
        case = f"{h}x{w}x{channels} scales {list(scales)} batch {batch} ({plan})"
        args = (*bf16((x, t1, t2)), aff)
        check_bf16_kernel("mdblock_bf16", case, lambda *a: mk.mdblock_fused(*a, scales),  # noqa: B023
                          lambda *a: mk.mdblock_taps_reference(*a, scales),  # noqa: B023
                          args, grad=batch < 8, skip_grad=(0,))
        worst["mdblock_bwd_bf16"] = max(worst["mdblock_bwd_bf16"],
                                        check_mdblock_backward(f"mdblock_bwd_bf16 {case}", *args, scales))

    staging_cache = check_staging(staging, dev, worst)

    log(f"[phase] 4 starts at {time.perf_counter() - started:.1f} s")
    # 4. Main path: the edit session on the card, then the same on the CPU;
    # seeded weights at unit gain, so the card-vs-CPU comparisons are not a
    # match of near-zero activations
    rng = np.random.RandomState(3)
    image = (rng.rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.8
    z_grid = rng.randn(10, 10).astype(np.float32)
    counters = Counts({"edit_tail": (et.edit_tail, "launches"), "rgb_beta_tail": (rt.rgb_beta_tail, "launches"),
                       "rgb_beta_head": (rh.rgb_beta_head, "launches"), "mdblock": (mk.mdblock_fused, "launches"),
                       "staging": (staging.stage_chunk, "launches"),
                       "rgb_beta_tail_bf16": (rt.rgb_beta_tail, "launches_bf16"),
                       "rgb_beta_head_bf16": (rh.rgb_beta_head, "launches_bf16"),
                       "mdblock_bf16": (mk.mdblock_fused, "launches_bf16"),
                       "mdblock_bwd": (mk.mdblock_fused, "launches_bwd"),
                       "mdblock_bwd_bf16": (mk.mdblock_fused, "launches_bwd_bf16"),
                       "rgb_beta_tail_bwd": (rt.rgb_beta_tail, "launches_bwd"),
                       "rgb_beta_tail_bwd_bf16": (rt.rgb_beta_tail, "launches_bwd_bf16"),
                       "rgb_beta_head_bwd": (rh.rgb_beta_head, "launches_bwd"),
                       "rgb_beta_head_bwd_bf16": (rh.rgb_beta_head, "launches_bwd_bf16")})

    def sessions_of(config, module):
        """A card and a CPU session of `config` from the same seeded
        unit-gain weights, through save_weights / load_weights (for IANv1
        that regenerates the MADE masks from the file's orderings)."""
        seeded = module.init(torch.Generator().manual_seed(0), "cpu")
        # the IAF's log-sigma outputs damped, so that exp(logsigma) stays near 1
        variables = from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), dev)
        n_params = sum(v.numel() for k, v in variables.items()
                       if not k.endswith(common.NON_TRAINABLE_SUFFIXES))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{config}.npz")
            save_weights(path, variables)
            with np.load(path) as f:
                assert not [k for k in f.files if k.endswith(".weights_mask")]
            pair = [EditSession(config, weights_path=path, device=d) for d in ("cuda", "cpu")]
        log(f"[main] {config} full width, {n_params} parameters, weights through save/load_weights")
        return pair

    def drive(label, card, cpu, expect, **script):
        """Counts to 0, the script on the card (the captured session) under
        the profiler, counts read and held against the device kernels it
        recorded; then the same script on the CPU and the comparison; then one
        capture a program, and none more for a fork. `expect` maps each kernel
        to 'steps' (paint and composite steps), 'decodes', '3 x decodes',
        'gradients' (a gradient a paint stroke and a scroll), '3 x gradients'
        or 0."""
        counters.zero()
        t0 = time.perf_counter()
        (steps, decodes, card_painted), seen = profiled(lambda: run_session_script(card, image, z_grid, **script))
        launches = counters.read()
        log(f"[main] {label} card script under the profiler: {time.perf_counter() - t0:.3f} s; paint and composite "
            f"steps {steps}, decodes {decodes}; launches {launches}")
        check_witnessed(label, launches, seen)
        gradients = steps - 1 + int(script.get("tail", True))  # the strokes, and the scroll
        for name, what in expect.items():
            want = {"steps": steps, "decodes": decodes, "3 x decodes": 3 * decodes, "gradients": gradients,
                    "3 x gradients": 3 * gradients, 0: 0}[what]
            assert launches[name] == want, f"{label}: {name} launched {launches[name]} times, not {want}"
            assert what == 0 or launches[name] > 0
        assert not any(n for name, n in launches.items() if name.endswith("_bf16")), launches
        _, _, cpu_painted = run_session_script(cpu, image, z_grid, **script)
        assert launches == counters.read()  # the CPU launches nothing
        compare_sessions(label, card, cpu, card_painted, cpu_painted)
        painted[label] = card_painted
        want = {"paint": 1, "scroll": int(script.get("tail", True)), "composite": 1, "encode": 1, "decode": 1}
        assert captures_of(card) == want, (label, captures_of(card))
        fork = card.fork()
        fork.infer(image)
        fork.paint_stroke(3, 50, 23, 54, (9, 99, 199), 0.5)
        fork.set_latents(z_grid * 0.5)
        assert fork.runner is card.runner and captures_of(card) == want, (label, captures_of(card))
        log(f"[main] {label}: captures {captures_of(card)} after the script (the brush moved, resized and switched "
            "sigma), none more for a fork's stroke and latent edit")
        return launches

    painted = {}  # the card's float32 state after each script, for the bf16 paths

    card, cpu = sessions_of("IAN_simple", ian_simple)
    main_launches = drive("IAN_simple", card, cpu,
                          {"edit_tail": "steps", "rgb_beta_tail": 0, "rgb_beta_head": 0, "mdblock": 0,
                           "staging": 0, "rgb_beta_tail_bwd": 0, "rgb_beta_head_bwd": 0})

    assert common.HEAD_MODE == "hybrid"
    card_v1, cpu_v1 = sessions_of("IANv1", ian_v1)
    masks = [k for k in card_v1.variables if k.endswith(".weights_mask")]
    assert len(masks) == 6 and all(card_v1.variables[k].is_cuda for k in masks)
    hybrid_launches = drive("IANv1 hybrid head", card_v1, cpu_v1,
                            {"edit_tail": "steps", "rgb_beta_tail": "decodes", "rgb_beta_head": 0,
                             "mdblock": 0, "rgb_beta_tail_bwd": "gradients", "rgb_beta_head_bwd": 0})
    main_launches["rgb_beta_tail"] = hybrid_launches["rgb_beta_tail"]
    main_launches["rgb_beta_tail_bwd"] = hybrid_launches["rgb_beta_tail_bwd"]
    fused_v1, fused_cpu_v1 = (EditSession("IANv1", variables=s.variables, device=s.device, head_mode="fused")
                              for s in (card_v1, cpu_v1))
    fused_launches = drive("IANv1 fused head", fused_v1, fused_cpu_v1,
                           {"edit_tail": "steps", "rgb_beta_tail": 0, "rgb_beta_head": "decodes",
                            "rgb_beta_tail_bwd": 0, "rgb_beta_head_bwd": "gradients"},
                           n_strokes=4, tail=False)
    main_launches["rgb_beta_head"] = fused_launches["rgb_beta_head"]
    main_launches["rgb_beta_head_bwd"] = fused_launches["rgb_beta_head_bwd"]

    # full IAN: the whole script with the three MDBLOCKs in the kernel's form,
    # a short one in the default per-op form, which must not reach the kernel
    assert common.MDBLOCK_MODE == "plain"
    card_ian, cpu_ian = sessions_of("IAN", ian)
    fused_ian, fused_cpu_ian = (EditSession("IAN", variables=s.variables, device=s.device, mdblock_mode="fused")
                                for s in (card_ian, cpu_ian))
    ian_launches = drive("IAN fused MDBLOCKs", fused_ian, fused_cpu_ian,
                         {"edit_tail": "steps", "rgb_beta_tail": "decodes", "rgb_beta_head": 0,
                          "mdblock": "3 x decodes", "mdblock_bwd": "3 x gradients", "rgb_beta_tail_bwd": "gradients"})
    main_launches["mdblock"] = ian_launches["mdblock"]
    main_launches["mdblock_bwd"] = ian_launches["mdblock_bwd"]
    drive("IAN per-op MDBLOCKs", card_ian, cpu_ian,
          {"edit_tail": "steps", "rgb_beta_tail": "decodes", "rgb_beta_head": 0, "mdblock": 0, "mdblock_bwd": 0,
           "rgb_beta_tail_bwd": "gradients"},
          n_strokes=4, tail=False)

    # captured against the runner's bodies called eagerly, every model and form
    for label, config, variables, options in (("IAN_simple", "IAN_simple", card.variables, {}),
                                              ("IANv1 hybrid head", "IANv1", card_v1.variables, {}),
                                              ("IANv1 fused head", "IANv1", card_v1.variables, {"head_mode": "fused"}),
                                              ("IAN per-op MDBLOCKs", "IAN", card_ian.variables, {}),
                                              ("IAN fused MDBLOCKs", "IAN", card_ian.variables,
                                               {"mdblock_mode": "fused"})):
        edit_captured_vs_eager(label, config, variables, image, z_grid, **options)

    log(f"[phase] 5 starts at {time.perf_counter() - started:.1f} s")
    # 5. API
    compare_api("IAN_simple", IAN("IAN_simple", variables=card.variables, device="cuda"),
                IAN("IAN_simple", variables=cpu.variables, device="cpu"), rng)
    compare_api("IANv1", IAN("IANv1", variables=card_v1.variables, device="cuda"),
                IAN("IANv1", variables=cpu_v1.variables, device="cpu"), rng)
    # the kernel's form on the card against the per-op form (library convs) on the CPU
    compare_api("IAN, card fused vs cpu per-op",
                IAN("IAN", variables=card_ian.variables, device="cuda", mdblock_mode="fused"),
                IAN("IAN", variables=cpu_ian.variables, device="cpu"), rng)
    # the API's programs captured against eager, every model and form, each
    # script's launches held to the device kernels the profiler recorded
    api_launches = {name: 0 for name in counters.forms}
    # (label, config, weights, forms, {kernel: launches a decode}, {kernel: launches a gradient})
    api_forms = (("IAN_simple", "IAN_simple", card.variables, {}, {}, {}),
                 ("IANv1 hybrid head", "IANv1", card_v1.variables, {"head_mode": "hybrid"}, {"rgb_beta_tail": 1},
                  {"rgb_beta_tail_bwd": 1}),
                 ("IANv1 fused head", "IANv1", card_v1.variables, {"head_mode": "fused"}, {"rgb_beta_head": 1},
                  {"rgb_beta_head_bwd": 1}),
                 ("IAN per-op MDBLOCKs", "IAN", card_ian.variables, {}, {"rgb_beta_tail": 1},
                  {"rgb_beta_tail_bwd": 1}),
                 ("IAN fused MDBLOCKs", "IAN", card_ian.variables, {"mdblock_mode": "fused"},
                  {"mdblock": 3, "rgb_beta_tail": 1}, {"mdblock_bwd": 3, "rgb_beta_tail_bwd": 1}))
    for i, (label, config, variables, forms, expect, per_gradient) in enumerate(api_forms):
        launches = drive_api(label, config, variables, counters, expect, 40 + i, per_gradient=per_gradient,
                             **forms)
        api_launches = {name: n + launches[name] for name, n in api_launches.items()}
    check_trap(root)

    log(f"[phase] 5b starts at {time.perf_counter() - started:.1f} s")
    # 5b. Serving: InferenceServer, ModelHost over HTTP and the web editor on
    # the same weights; each case with the counts set to 0 just before it
    t0 = time.perf_counter()
    serving_launches, serve_times = drive_serving(
        {"IAN_simple": card.variables, "IANv1": card_v1.variables, "IAN": card_ian.variables}, counters, smi)
    web_launches, serve_times["web_editor"] = drive_web(card.variables, counters, smi)
    serving_launches = {name: n + web_launches[name] for name, n in serving_launches.items()}
    assert all(serving_launches[name] > 0 for name in ("edit_tail", "rgb_beta_tail", "rgb_beta_head", "mdblock",
                                                        "staging")), serving_launches
    serve_times["phase_s"] = time.perf_counter() - t0
    log(f"[serve] launches on the serving and web paths: {serving_launches}; phase 5b took "
        f"{serve_times['phase_s']:.1f} s")

    log(f"[phase] 5c starts at {time.perf_counter() - started:.1f} s")
    # 5c. bfloat16: the API, the session and the servers with dtype=bf16 on
    # the same weights (cast once), each path with the counts set to 0 just
    # before it and read just after, held against the card's float32 results
    # within npe_tpu's bf16 bounds; the bf16 kernels' launches summed
    t0 = time.perf_counter()
    bf16_launches = {name: 0 for name in counters.forms}
    bf16_sessions = {}
    # (label, config, forms, {kernel: what launches it}, script), the float32 scripts' labels
    bf16_paths = (("IAN_simple", "IAN_simple", {}, {}, {}),
                  ("IANv1 hybrid head", "IANv1", {"head_mode": "hybrid"},
                   {"rgb_beta_tail_bf16": "decodes", "rgb_beta_tail_bwd_bf16": "gradients"}, {}),
                  ("IANv1 fused head", "IANv1", {"head_mode": "fused"},
                   {"rgb_beta_head_bf16": "decodes", "rgb_beta_head_bwd_bf16": "gradients"},
                   {"n_strokes": 4, "tail": False}),
                  ("IAN fused MDBLOCKs", "IAN", {"mdblock_mode": "fused"},
                   {"rgb_beta_tail_bf16": "decodes", "mdblock_bf16": "3 x decodes",
                    "mdblock_bwd_bf16": "3 x gradients", "rgb_beta_tail_bwd_bf16": "gradients"}, {}),
                  ("IAN per-op MDBLOCKs", "IAN", {"mdblock_mode": "plain"},
                   {"rgb_beta_tail_bf16": "decodes", "rgb_beta_tail_bwd_bf16": "gradients"},
                   {"n_strokes": 4, "tail": False}))
    variables_of = {"IAN_simple": card.variables, "IANv1": card_v1.variables, "IAN": card_ian.variables}
    x64 = rng.uniform(-1, 1, (64, 3, 64, 64)).astype(np.float32)
    rgb = np.broadcast_to(np.float32([0.5, -0.5, 0.2])[None, :, None, None], (1, 3, 64, 64))

    def expect_launches(label, launches, expect, decodes, steps, gradients):
        """`expect`'s kernels launched once a decode (three times for the
        MDBLOCK), the backwards once a gradient (the MDBLOCK's three times),
        edit_tail once a paint or composite step in float32, nothing else."""
        wants = {"decodes": decodes, "3 x decodes": 3 * decodes, "gradients": gradients,
                 "3 x gradients": 3 * gradients}
        for name, n in launches.items():
            want = wants[expect[name]] if name in expect else steps if name == "edit_tail" else 0
            assert n == want, f"{label}: {name} launched {n} times, not {want}"
            bf16_launches[name] += n

    for label, config, forms, expect, script in bf16_paths:
        # api.IAN: encode_images, sample_at and imgradRGB (one decode each of the two)
        m32 = IAN(config, variables=variables_of[config], device="cuda", **forms)
        z32 = m32.encode_images(x64)
        y32, g32 = m32.sample_at(z32), m32.imgradRGB(8, 8, 24, 24, rgb, z32[:1])
        m16 = IAN(config, variables=variables_of[config], device="cuda", dtype=torch.bfloat16, **forms)
        assert all(t.dtype == torch.bfloat16 for t in m16.variables.values() if t.is_floating_point())
        counters.zero()
        z16 = m16.encode_images(x64)
        y16, g16 = m16.sample_at(z32), m16.imgradRGB(8, 8, 24, 24, rgb, z32[:1])
        torch.cuda.synchronize()
        launches = counters.read()
        log(f"[bf16] {label} api.IAN(dtype=bf16), encode_images and sample_at at batch 64, imgradRGB: "
            f"launches {launches}")
        expect_launches(f"{label} api", launches, expect, 2, 0, 1)
        assert z16.dtype == y16.dtype == g16.dtype == np.float32
        mean_close(f"[bf16] {label} encode_images, bf16 vs float32", z16, z32, Z_BOUND)
        mean_close(f"[bf16] {label} sample_at, bf16 vs float32", y16, y32, IMAGE_BOUND)
        cosine = float((g16 * g32).sum() / np.linalg.norm(g16) / np.linalg.norm(g32))
        log(f"  [bf16] {label} imgradRGB, bf16 vs float32: cosine {cosine:.5f}")
        assert cosine > 0.9, f"{label}: the bf16 gradient points elsewhere ({cosine})"
        # EditSession: the float32 scripts' strokes
        session = EditSession(config, variables=variables_of[config], device="cuda", dtype="bfloat16", **forms)
        counters.zero()
        (steps, decodes, got), seen = profiled(
            lambda: run_session_script(session, image, z_grid, **script))  # noqa: B023
        launches = counters.read()
        log(f"[bf16] {label} EditSession(dtype=bf16) script: paint and composite steps {steps}, decodes {decodes}; "
            f"launches {launches}; captures {captures_of(session)}")
        check_witnessed(f"{label} bf16 session", launches, seen)
        expect_launches(f"{label} session", launches, expect, decodes, steps,
                        steps - 1 + int(script.get("tail", True)))
        assert captures_of(session) == {"paint": 1, "scroll": int(script.get("tail", True)), "composite": 1,
                                        "encode": 1, "decode": 1}
        z32_painted, im32_painted, _ = painted[label]
        assert session.Z.dtype == torch.float32 and got[1].dtype == np.float32 and np.isfinite(session.IM).all()
        mean_close(f"[bf16] {label} Z after the strokes, bf16 vs float32", got[0], z32_painted, Z_BOUND)
        mean_close(f"[bf16] {label} IM after the strokes, bf16 vs float32", got[1], im32_painted, IMAGE_BOUND)
        bf16_sessions[label] = session
        per_decode = {name: 3 if what == "3 x decodes" else 1 for name, what in expect.items()
                      if what.endswith("decodes")}
        per_gradient = {name: 3 if what == "3 x gradients" else 1 for name, what in expect.items()
                        if what.endswith("gradients")}
        launches = drive_api(f"{label} bf16", config, variables_of[config], counters, per_decode, 60 + len(bf16_sessions),
                             dtype=torch.bfloat16, per_gradient=per_gradient, **forms)
        api_launches = {name: n + launches[name] for name, n in api_launches.items()}
        edit_captured_vs_eager(f"{label} bf16", config, variables_of[config], image, z_grid, dtype="bfloat16",
                               **forms)
    bf16_serving, serve_times["bf16"] = drive_serving_bf16(variables_of, counters, smi)
    bf16_kernels = ("rgb_beta_tail_bf16", "rgb_beta_head_bf16", "mdblock_bf16")
    assert all(bf16_launches[name] > 0 and bf16_serving[name] > 0 for name in bf16_kernels), (bf16_launches,
                                                                                                 bf16_serving)
    bf16_backwards = ("mdblock_bwd_bf16", "rgb_beta_tail_bwd_bf16", "rgb_beta_head_bwd_bf16")
    main_launches.update({name: bf16_launches[name] for name in bf16_kernels + bf16_backwards})
    assert all(bf16_launches[name] > 0 and not bf16_serving[name] for name in bf16_backwards), (bf16_launches,
                                                                                              bf16_serving)
    serving_launches.update({name: bf16_serving[name] for name in bf16_kernels})
    serving_launches["staging"] += bf16_serving["staging"]  # the float32 kernel on the bf16 uint8 wires
    log(f"[bf16] launches on the bf16 API and session paths {bf16_launches}, on the bf16 serving paths "
        f"{bf16_serving}; phase 5c took {time.perf_counter() - t0:.1f} s")

    log(f"[phase] 6 starts at {time.perf_counter() - started:.1f} s")
    # 6. Training: the trainer's main path on IAN_simple, then single steps
    main_launches["staging"] = drive_training(counters)

    # one G and one D step of IAN_simple at full width, batch 16, from the
    # same unit-gain weights, batch, z_rand and noise, on the card and on the
    # CPU: float32 as the trainer runs it, then float64 for the gradients
    cfg_simple = dict(ian_simple.cfg)
    for dtype, grad_tol in ((torch.float32, GRAD32_TOL), (torch.float64, GRAD64_TOL)):
        results = [step_results(ian_simple, s.variables, step_batch(cfg_simple, 16, 30, s.device, dtype), dtype)
                   for s in (card, cpu)]
        compare_steps(f"IAN_simple batch 16 {str(dtype).split('.')[1]}", *results, grad_tol)
    tail_step_launches = {label: kernel_steps(label, module, variables, counters)
                          for label, module, variables in (("IANv1", ian_v1, card_v1.variables),
                                                           ("IAN", ian, card_ian.variables))}
    # the trainer's captured chunk against the eager chunk, each model (its
    # launches and phase 7's captured chunks' make the entries'
    # training_captured_launches)
    captured_launches = {name: 0 for name in counters.forms}
    for label, module, variables, dtype in (("IAN_simple", ian_simple, card.variables, torch.float64),
                                            ("IANv1", ian_v1, card_v1.variables, torch.float32),
                                            ("IAN", ian, card_ian.variables, torch.float32)):
        launches = captured_vs_eager(label, module, variables, counters, dtype)
        captured_launches = {k: n + launches[k] for k, n in captured_launches.items()}
    assert captured_launches == dict({name: 0 for name in counters.forms}, rgb_beta_tail=2 * 2 * CAPTURE_STEPS,
                                     rgb_beta_tail_bwd=2 * TAIL_BWD_PER_PAIR * CAPTURE_STEPS // 2), captured_launches

    log(f"[phase] 6b starts at {time.perf_counter() - started:.1f} s")
    # 6b. bf16 training (cfg['compute_dtype']) and the rest of the trainer:
    # one G and one D step of each model in bf16 beside float32 on the same
    # weights and batch (IAN_simple at its batch of 128, held to npe_tpu's bf16
    # trajectory bounds; IANv1 and full IAN at 16, through the tail's bf16
    # form), then train() through the native loader, bf16, encode-FID and the
    # profiler, and the sample CLI; each path with the counts set to 0 just
    # before it and read just after
    t0 = time.perf_counter()
    bf16_rows, bf16_simple = bf16_steps("IAN_simple", ian_simple, card.variables, counters, TRAIN_BATCH, False)
    np.testing.assert_allclose(bf16_rows["bfloat16"], bf16_rows["float32"], rtol=BF16_TRAIN_RTOL,
                               atol=BF16_TRAIN_ATOL, err_msg="IAN_simple bf16 step vs float32")
    training_launches = {name: 0 for name in counters.forms}
    for label, module, variables in (("IANv1", ian_v1, card_v1.variables), ("IAN", ian, card_ian.variables)):
        _, launches = bf16_steps(label, module, variables, counters, 16, True)
        training_launches = {name: n + launches[name] for name, n in training_launches.items()}
    training_launches["staging"] = drive_training_bf16(counters, smi)
    assert training_launches["rgb_beta_tail_bf16"] == 8 and training_launches["staging"] == 4, training_launches
    assert training_launches["rgb_beta_tail_bwd_bf16"] == 2 * TAIL_BWD_PER_PAIR, training_launches
    log(f"[train] launches on the bf16 training paths {training_launches}; phase 6b took "
        f"{time.perf_counter() - t0:.1f} s")

    log(f"[phase] 6c starts at {time.perf_counter() - started:.1f} s")
    # 6c. [eval]: the checkpoints' and the sample CLI's programs of each model,
    # captured against eager, their launches held to the profiler's kernels,
    # and one checkpoint's evaluation timed captured and eager
    t0 = time.perf_counter()
    eval_launches, eval_times = drive_evaluation(
        {"IAN_simple": card.variables, "IANv1": card_v1.variables, "IAN": card_ian.variables}, counters, smi)
    assert eval_launches == dict({name: 0 for name in counters.forms}, rgb_beta_tail=10), eval_launches
    eval_times["phase_s"] = time.perf_counter() - t0
    log(f"[eval] launches on the evaluation programs' replayed scripts {eval_launches}; phase 6c took "
        f"{eval_times['phase_s']:.1f} s")

    log(f"[phase] 7 starts at {time.perf_counter() - started:.1f} s")
    # 7. Times: each session's strokes captured (its path) and eager
    strokes = {}
    for label, session, n, top in (("IAN_simple", card, TIMED_STROKES, 12),
                                   ("IANv1 hybrid head", card_v1, TIMED_STROKES, 16),
                                   ("IANv1 fused head", fused_v1, TIMED_STROKES, 6),
                                   ("IAN per-op MDBLOCKs", card_ian, TIMED_STROKES, 14),
                                   ("IAN fused MDBLOCKs", fused_ian, TIMED_STROKES // 2, 14)):
        strokes[label] = time_edit_paths(label, session, image, smi, n, top)
    log(f"[phase] 7's strokes done at {time.perf_counter() - started:.1f} s")
    # the API's methods and the editor's first calls, captured beside eager
    api_times, first_calls = {}, {}
    for label, config, variables, forms, _, _ in api_forms:
        api_times[label] = time_api(label, config, variables, smi, **forms)
        first_calls[label] = editor_first_calls(label, config, variables, image, z_grid, smi, **forms)
    log(f"[phase] 7's API times done at {time.perf_counter() - started:.1f} s")

    # what the head's weight packing costs on every decode (two a stroke)
    for as_taps, form in ((False, "hybrid"), (True, "fused")):
        pack = lambda: common.packed_head_weights(card_v1.variables, HEAD_SCALES, 4, as_taps)  # noqa: E731
        log(f"[time] head weight packing, {form} form, per decode: {cuda_ms(pack, 200):.4f} ms eager back "
            f"to back (host-bound), {graph_ms(pack, iters=20):.4f} ms device time (CUDA graph)")

    # edit_tail beside an empty kernel of its grid and block, launched the same
    # way: the launch floor, what no design of the kernel can go below
    _, radius = et.gaussian_kernel_1d(0.7)
    bm = et.blur_matrix(64, 0.7, device=dev)
    edit_times = {}
    for batch in (1, 8):
        xh, recon, err, um = edit_tail_inputs(batch, "random", 2, dev)
        edit_times[batch] = {
            "ms": graph_ms(lambda: et.edit_tail(xh, recon, err, um, 0.7)),  # noqa: B023
            "plain_ms": graph_ms(lambda: et.edit_tail_reference(xh, recon, err, bm, um)),  # noqa: B023
            "launch_floor_ms": graph_ms(lambda: launch_floor.edit_tail_floor(batch, 64, 0.7, dev)),  # noqa: B023
            "bands": 64 // et.band_rows(batch, 64, radius, torch.cuda.get_device_properties(dev).multi_processor_count),
        }
        t = edit_times[batch]
        bound_ms, bound_by = edit_tail_bound_ms(batch, 64, radius)
        log(f"[time] edit_tail batch {batch}, device time (CUDA graph): kernel {t['ms']:.5f} ms ({t['bands']} bands "
            f"an image), plain {t['plain_ms']:.5f} ms, empty kernel of the same grid {t['launch_floor_ms']:.5f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}) ({smi})")
    xh, recon, err, um = edit_tail_inputs(1, "random", 2, dev)
    loop_k = cuda_ms(lambda: et.edit_tail(xh, recon, err, um, 0.7), 2000)
    loop_p = cuda_ms(lambda: et.edit_tail_reference(xh, recon, err, bm, um), 2000)
    log(f"[time] edit_tail batch 1, eager calls back to back: wrapper {loop_k:.5f} ms, "
        f"plain {loop_p:.5f} ms per call")
    bound_ms, bound_by = edit_tail_bound_ms(1, 64, radius)
    entries = [{"name": "edit_tail", "source": et.SOURCE, "replaces": et.REPLACES, "ms": edit_times[1]["ms"],
                "plain_ms": edit_times[1]["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                "launch_floor_ms": edit_times[1]["launch_floor_ms"]}]

    # the tail alone, and the head; beside the head's trunk, the hybrid
    # form's trunk, one cuDNN conv over the s2d map (a yardstick for the trunk,
    # not a computation of the whole head)
    k_trunk = common.packed_head_weights(card_v1.variables, HEAD_SCALES, 4, as_taps=False)[0]
    for batch in (1, 8, 16):  # 16: IANv1's and full IAN's training batch, the tail alone
        x, tr, trunk, tg, tb = head_inputs(batch, 64, 30 + batch, dev)
        cases = [("rgb_beta_tail", rt, rt.rgb_beta_tail, rt.rgb_beta_tail_reference, (trunk, tg, tb),
                  rgb_beta_tail_bound_ms(batch))]
        if batch < 16:
            cases.append(("rgb_beta_head", rh, head, head_plain, (x, tr, tg, tb), rgb_beta_head_bound_ms(batch, 64)))
        for name, mod, kernel, plain, args, bound in cases:
            with torch.no_grad():
                k_ms = graph_ms(lambda: kernel(*args), iters=50)  # noqa: B023
                p_ms = graph_ms(lambda: plain(*args), iters=50)  # noqa: B023
            line = (f"[time] {name} batch {batch}, device time (CUDA graph): kernel {k_ms:.5f} ms, "
                    f"plain {p_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]})")
            entry = {"name": name, "source": mod.SOURCE, "replaces": mod.REPLACES, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1]}
            if name == "rgb_beta_head":
                with torch.no_grad():
                    trunk_ms = graph_ms(lambda: rh.trunk_only(x, tr, HEAD_SCALES), iters=50)  # noqa: B023
                    cudnn_ms = graph_ms(lambda: conv2d(space_to_depth(x, 4), k_trunk, padding=1), iters=50)  # noqa: B023
                line += (f"; its trunk (launch and slice sum) {trunk_ms:.5f} ms, the hybrid form's cuDNN trunk conv "
                         f"{cudnn_ms:.5f} ms; the s2d form's bound {rgb_beta_head_s2d_bound_ms(batch, 64)[0]:.6f} ms")
                entry.update(trunk_ms=trunk_ms, trunk_library_ms=cudnn_ms)
            log(f"{line} ({smi})")
            if batch == 1:
                entries.append(entry)
    # the whole head from the weights, at the stroke's batch and the API's:
    # both kernel forms, and the all-library alternative to them, the fused
    # kernel's plain version over the fused form's weights
    v1 = card_v1.variables
    for batch in (1, 128):
        h = torch.from_numpy(rng.randn(batch, 64, 64, 64).astype(np.float32)).to(dev)
        forms = {
            "plain version of fused": lambda: rh.rgb_beta_head_reference(  # noqa: B023
                h, *common.packed_head_weights(v1, HEAD_SCALES, 4, as_taps=True), HEAD_SCALES),  # noqa: B023
            "hybrid": lambda: common.rgb_beta_head(v1, h, HEAD_SCALES, mode="hybrid"),  # noqa: B023
            "fused": lambda: common.rgb_beta_head(v1, h, HEAD_SCALES, mode="fused"),  # noqa: B023
        }
        with torch.no_grad():
            for form, fn in forms.items():
                log(f"[time] whole head, {form} form, batch {batch}, weight packing included, device time "
                    f"(CUDA graph): {graph_ms(fn, iters=20 if batch == 1 else 5):.5f} ms ({smi})")

    # mdblock_fused at full IAN's three shapes: the kernel and its plain
    # version on prepared taps, then (batch 1 and 8) the whole block from the
    # weights (tap stacking or kernel composing included) in both forms; at
    # batch 128, the throughput use, the kernel is held to its plain version
    # once more. Two bounds: the kernel's route (3xTF32 on the tensor cores),
    # the entry's bound_ms, and float32 outside them, on the [time] lines only.
    vi = card_ian.variables
    per_shape = []
    with torch.no_grad():
        for name, channels, size, scales in MDBLOCK_SHAPES:
            for batch in (1, 8, 128):
                args = mdblock_inputs(batch, channels, size, scales, 50 + batch, dev)
                reps = dict(iters=5, reps=4) if batch == 128 else dict(iters=20)
                k_ms = graph_ms(lambda: mk.mdblock_fused(*args, scales), **reps)
                p_ms = graph_ms(lambda: mk.mdblock_taps_reference(*args, scales), **reps)
                bound = mdblock_bound_ms(batch, channels, size, scales)
                fp32_bound = mdblock_bound_ms(batch, channels, size, scales, route="fp32")
                line = (f"[time] mdblock {size}x{size}x{channels} batch {batch}, device time (CUDA graph): kernel "
                        f"{k_ms:.5f} ms, plain {p_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}, 3xTF32), "
                        f"float32 bound {fp32_bound[0]:.6f} ms ({fp32_bound[1]})")
                if batch == 128:
                    e = float((mk.mdblock_fused(*args, scales) - mk.mdblock_taps_reference(*args, scales)).abs().max())
                    worst["mdblock"] = max(worst["mdblock"], e)
                    assert e <= MDBLOCK_TOL, f"mdblock batch 128 disagrees with its plain version: {e}"
                    log(f"{line}; max abs err {e:.3e} (tol {MDBLOCK_TOL}) ({smi})")
                    continue
                forms = {mode: graph_ms(lambda: common.mdblock(vi, None, name, args[0], scales, common.LRELU,
                                                               False, mode=mode), iters=20)
                         for mode in common.MDBLOCK_MODES}
                log(f"{line}; the whole block from the weights: fused {forms['fused']:.5f} ms, per-op "
                    f"{forms['plain']:.5f} ms ({smi})")
                if batch == 1:
                    per_shape.append({"shape": f"{size}x{size}x{channels}", "ms": k_ms, "plain_ms": p_ms,
                                      "bound_ms": bound[0], "bound_by": bound[1], "per_op_ms": forms["plain"]})
    # one decode launches the kernel once per shape: the entry is their sum;
    # bound_by names what bounds the largest of the three
    entries.append({"name": "mdblock", "source": mk.SOURCE, "replaces": mk.REPLACES,
                    **{key: sum(e[key] for e in per_shape) for key in ("ms", "plain_ms", "bound_ms")},
                    "bound_by": max(per_shape, key=lambda e: e["bound_ms"])["bound_by"], "per_shape": per_shape})

    def stack_taps():
        """What the fused form makes of the weights on every decode."""
        for name, _, _, scales in MDBLOCK_SHAPES:
            common._stacked_mdcl_taps(vi, name, scales)
            common._stacked_mdcl_taps(vi, f"{name}2", scales)
            torch.stack([a for i in range(3) for a in common._bn_affine(vi, f"{name}bnorm{i}")])

    # the backward kernels (x's gradient) at the same shapes, batch 1 and 8
    bwd_times = {(f"{size}x{size}x{channels}", batch): time_mdblock_backward(vi, name, channels, size, scales, batch,
                                                                             110 + batch, smi)
                 for name, channels, size, scales in MDBLOCK_SHAPES for batch in (1, 8, 128)}
    entries.append(mdblock_backward_entry("mdblock_bwd", mk.BWD_SOURCE, bwd_times))
    # the RGB-Beta head's backward kernels: the tail's at the stroke's batch
    # (first the trunk's gradient alone, the edit path's call: the entry),
    # with the taps' gradients at the stroke's, the training step's and a
    # large batch, and the D step's trunk-only call; x's gradient of the head
    # at IANv1's and full IAN's widths
    tail_bwd_cases = [time_tail_backward(1, torch.float32, False, smi)]
    tail_bwd_cases += [time_tail_backward(batch, torch.float32, True, smi) for batch in (1, 16, 128)]
    tail_bwd_cases.append(time_tail_backward(16, torch.float32, False, smi))
    entries.append(backward_entry("rgb_beta_tail_bwd", rt.SOURCE, rt.REPLACES_BWD, tail_bwd_cases))
    entries.append(backward_entry("rgb_beta_head_bwd", rh.SOURCE, rh.REPLACES_BWD,
                                  [time_head_backward(batch, channels, torch.float32, smi)
                                   for batch, channels in ((1, 64), (8, 64), (1, 128))]))

    with torch.no_grad():
        log(f"[time] MDBLOCK tap stacking (six stacks, three affines), per decode: {cuda_ms(stack_taps, 100):.4f} ms "
            f"eager back to back, {graph_ms(stack_taps, iters=10):.4f} ms device time (CUDA graph)")

    x128 = torch.from_numpy(rng.uniform(-1, 1, (128, 3, 64, 64)).astype(np.float32)).to(dev)
    rates = {}
    for label, module, v, options in (("IAN_simple", ian_simple, card.variables, {}), ("IANv1", ian_v1, v1, {}),
                                      ("IAN per-op MDBLOCKs", ian, vi, {}),
                                      ("IAN fused MDBLOCKs", ian, vi, {"mdblock_mode": "fused"})):
        def enc_dec():
            with torch.no_grad():
                module.decode(v, module.encode(v, x128), **options)

        ed_ms = cuda_ms(enc_dec, 20)
        rates[label] = 128e3 / ed_ms
        log(f"[time] {label} encode+decode batch 128: {ed_ms:.4f} ms/batch, {rates[label]:.1f} imgs/s ({smi})")

    log(f"[phase] 7b starts at {time.perf_counter() - started:.1f} s")
    # 7b. bfloat16 times: the three bf16 kernels beside their bounds (2 bytes
    # an element, 989 TFLOP/s), encode+decode at bench.py's headline batch of
    # 256 (bench_torch.py's function), and the bf16 strokes (bench_torch_edit.py's)
    bf16_times = {"kernels": {}}
    with torch.no_grad():
        for batch in (1, 128):
            _, _, trunk32, tg, tb = head_inputs(batch, 64, 90 + batch, dev)
            trunk, tg, tb = (t.to(torch.bfloat16) for t in (trunk32, tg, tb))
            for what, fn, args, bound in (
                    ("bf16 trunk", rt.rgb_beta_tail, (trunk, tg, tb), rgb_beta_tail_bound_ms(batch, "bfloat16")),
                    ("float32 trunk (tail_only)", rt.tail_only, (trunk32, tg, tb),
                     rgb_beta_tail_bound_ms(batch, "bfloat16", trunk_elt=4))):
                k_ms = graph_ms(lambda: fn(*args), iters=50)  # noqa: B023
                p_ms = graph_ms(lambda: rt.rgb_beta_tail_reference(*args), iters=50)  # noqa: B023
                log(f"[time] rgb_beta_tail_bf16 batch {batch}, {what}, device time (CUDA graph): kernel {k_ms:.5f} ms, "
                    f"plain {p_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}) ({smi})")
                if batch == 1 and fn is rt.rgb_beta_tail:
                    entries.append({"name": "rgb_beta_tail_bf16", "source": rt.SOURCE, "replaces": rt.REPLACES,
                                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1]})
                bf16_times["kernels"][f"rgb_beta_tail_bf16 batch {batch} {what}"] = k_ms
        for batch in (1, 128):
            x, tr, _, tg, tb = (t.to(torch.bfloat16) for t in head_inputs(batch, 64, 95 + batch, dev))
            bound = rgb_beta_head_bound_ms(batch, 64, dtype="bfloat16")
            k_ms = graph_ms(lambda: head(x, tr, tg, tb), iters=50 if batch == 1 else 5)  # noqa: B023
            p_ms = graph_ms(lambda: head_plain(x, tr, tg, tb), iters=50 if batch == 1 else 5)  # noqa: B023
            trunk_ms = graph_ms(lambda: rh.trunk_only(x, tr, HEAD_SCALES), iters=50 if batch == 1 else 5)  # noqa: B023
            log(f"[time] rgb_beta_head_bf16 C 64 batch {batch}, device time (CUDA graph): kernel {k_ms:.5f} ms, plain "
                f"{p_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}); its trunk {trunk_ms:.5f} ms ({smi})")
            if batch == 1:
                entries.append({"name": "rgb_beta_head_bf16", "source": rh.SOURCE, "replaces": rh.REPLACES,
                                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
                                "trunk_ms": trunk_ms})
            bf16_times["kernels"][f"rgb_beta_head_bf16 C 64 batch {batch}"] = k_ms
        # the bf16 MDBLOCK beside its yardstick: the whole bf16 block from the
        # bf16 weights in both forms (tap stacking, and the kernel's repacking,
        # included), the per-op form a composition of library calls, not one
        per_shape = []
        vi16 = bf16_sessions["IAN fused MDBLOCKs"].variables
        for name, channels, size, scales in MDBLOCK_SHAPES:
            for batch in (1, 128):
                x, t1, t2, aff = mdblock_inputs(batch, channels, size, scales, 100 + batch, dev)
                args = (x.to(torch.bfloat16), t1.to(torch.bfloat16), t2.to(torch.bfloat16), aff)
                reps = dict(iters=5, reps=4) if batch == 128 else dict(iters=20)
                k_ms = graph_ms(lambda: mk.mdblock_fused(*args, scales), **reps)  # noqa: B023
                p_ms = graph_ms(lambda: mk.mdblock_taps_reference(*args, scales), **reps)  # noqa: B023
                forms = {mode: graph_ms(lambda: common.mdblock(vi16, None, name, args[0], scales,  # noqa: B023
                                                               common.LRELU, False, mode=mode), **reps)  # noqa: B023
                         for mode in common.MDBLOCK_MODES}
                bound = mdblock_bound_ms(batch, channels, size, scales, route="bf16")
                log(f"[time] mdblock_bf16 {size}x{size}x{channels} batch {batch}, device time (CUDA graph): kernel "
                    f"{k_ms:.5f} ms, plain {p_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}); the whole bf16 block "
                    f"from the weights: fused {forms['fused']:.5f} ms, per-op {forms['plain']:.5f} ms ({smi})")
                key = f"{size}x{size}x{channels} batch {batch}"
                bf16_times["kernels"][f"mdblock_bf16 {key}"] = k_ms
                bf16_times.setdefault("mdblock_bf16_blocks", {})[key] = {"kernel_ms": k_ms, "bound_ms": bound[0],
                                                                        "fused_block_ms": forms["fused"],
                                                                        "per_op_block_ms": forms["plain"]}
                if batch == 1:
                    per_shape.append({"shape": f"{size}x{size}x{channels}", "ms": k_ms, "plain_ms": p_ms,
                                      "bound_ms": bound[0], "bound_by": bound[1], "per_op_ms": forms["plain"]})
        entries.append({"name": "mdblock_bf16", "source": mk.BF16_SOURCE, "replaces": mk.REPLACES,
                        **{key: sum(e[key] for e in per_shape) for key in ("ms", "plain_ms", "bound_ms")},
                        "bound_by": max(per_shape, key=lambda e: e["bound_ms"])["bound_by"], "per_shape": per_shape})
    # the bf16 backward kernels (x's gradient) at batch 1, 8 and 128
    bwd_times = {(f"{size}x{size}x{channels}", batch): time_mdblock_backward(vi16, name, channels, size, scales, batch,
                                                                             120 + batch, smi, torch.bfloat16)
                 for name, channels, size, scales in MDBLOCK_SHAPES for batch in (1, 8, 128)}
    bf16_times["mdblock_bwd_bf16_blocks"] = {f"{shape} batch {batch}": t for (shape, batch), t in bwd_times.items()}
    entries.append(mdblock_backward_entry("mdblock_bwd_bf16", mk.BWD_SOURCE, bwd_times))
    # the bf16 RGB-Beta head backwards, as in float32; the tail's over a bf16
    # trunk, and once over the fused head's float32 one
    half = torch.bfloat16
    tail_bwd_cases = [time_tail_backward(1, half, False, smi)]
    tail_bwd_cases += [time_tail_backward(batch, half, True, smi) for batch in (1, 16, 128)]
    tail_bwd_cases += [time_tail_backward(16, half, False, smi), time_tail_backward(1, half, False, smi, torch.float32)]
    entries.append(backward_entry("rgb_beta_tail_bwd_bf16", rt.SOURCE, rt.REPLACES_BWD, tail_bwd_cases))
    entries.append(backward_entry("rgb_beta_head_bwd_bf16", rh.SOURCE, rh.REPLACES_BWD,
                                  [time_head_backward(batch, channels, half, smi)
                                   for batch, channels in ((1, 64), (8, 64), (1, 128))]))

    log(f"[phase] 7b's kernels done at {time.perf_counter() - started:.1f} s")
    x256 = torch.from_numpy(rng.uniform(-1, 1, (256, 3, 64, 64)).astype(np.float32)).to(dev, torch.bfloat16)
    bf16_times["encode_decode_imgs_per_s_b256"] = {}
    for label, _, forms, _, _ in bf16_paths:
        session = bf16_sessions[label]
        rate, _, spread = bench_torch.encode_decode_rate(session.module, session.variables, x256, 3, 3, forms)
        bf16_times["encode_decode_imgs_per_s_b256"][label] = rate
        log(f"[time] {label} bf16 encode+decode batch 256: {rate:.1f} imgs/s (median of 3 rounds of 3 chained "
            f"passes, spread {spread:.3f}) ({smi})")
    bf16_times["strokes"] = {}
    for label, session in bf16_sessions.items():
        n = BF16_TIMED_STROKES // 2 if "fused MDBLOCKs" in label else BF16_TIMED_STROKES
        bf16_times["strokes"][label] = time_edit_paths(f"{label} bf16", session, image, smi, n, 6)
    del x256
    log(f"[phase] 7b's strokes done at {time.perf_counter() - started:.1f} s")
    bf16_times["api"] = {label: time_api(f"{label} bf16", config, variables_of[config], smi, dtype=torch.bfloat16,
                                         **forms) for label, config, forms, _, _ in bf16_paths}

    # the staging kernel at the trainer's two chunk sizes (IAN_simple's 64
    # batches of 128; IAN's and IANv1's 64 of 16), rows gathered out of a
    # 16384-image dataset resident on the card
    staging_times = {}
    for n in (8192, 1024):
        idx = torch.from_numpy(np.random.RandomState(n).randint(0, 16384, n)).to(dev)
        k_ms = graph_ms(lambda: staging.stage_chunk(staging_cache, idx), iters=10, reps=10)
        p_ms = graph_ms(lambda: staging.stage_chunk_reference(staging_cache, idx), iters=10, reps=10)
        bound = staging_bound_ms(n, 3 * 64 * 64)
        staging_times[n] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1]}
        log(f"[time] staging n {n} of 16384 3x64x64, device time (CUDA graph): kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}): {bound[0] / k_ms:.3f} of the roofline ({smi})")
    entries.append({"name": "staging", "source": staging.SOURCE, "replaces": staging.REPLACES,
                    **staging_times[TRAIN_BATCH * TRAIN_BATCHES_PER_CHUNK], "n": TRAIN_BATCH * TRAIN_BATCHES_PER_CHUNK,
                    "per_n": {str(n): t for n, t in staging_times.items()}})
    del staging_cache

    log(f"[phase] 7, training times, starts at {time.perf_counter() - started:.1f} s")
    # training: seeded default-init weights on the card (what `train` starts from),
    # eager and captured
    training = {}
    for label, batch_size, bpc in (("IAN_simple", 128, 8), ("IANv1", 16, 16), ("IAN", 16, 16)):
        # float32 (TF32 off), then bf16 compute over float32 masters, in turns
        for name, extra in ((label, {}), (f"{label} bf16", {"compute_dtype": "bfloat16"})):
            training[name], launches = time_training(name, label, batch_size, bpc, smi, counters, label != "IAN_simple",
                                                     14 if label == "IAN_simple" else 8, **extra)
            captured_launches = {k: n + launches[k] for k, n in captured_launches.items()}
        if label == "IAN_simple":
            # PyTorch's own default lets cuDNN run float32 convolutions in TF32
            torch.backends.cudnn.allow_tf32 = True
            training["IAN_simple, cuDNN TF32 on"] = time_training("IAN_simple, cuDNN TF32 on", label, batch_size,
                                                                  bpc, smi, counters, False, 6)[0]
            torch.backends.cudnn.allow_tf32 = False
            training["data_paths_ms_per_chunk"] = time_data_paths(smi)
    # the bf16 tail as a bf16 step of IANv1 and full IAN runs it (batch 16, a
    # bf16 trunk): the kernel forward, its backward kernels (the trunk's and
    # the taps' gradients, as the G step asks), and the plain version's VJP in
    # bf16 that they replace (which recomputes the plain forward), as device
    # time and eager
    _, _, trunk, tg, tb = (t.to(torch.bfloat16) for t in head_inputs(16, 64, 97, dev))
    g_out = torch.randn((16, 48) + tuple(trunk.shape[2:]), device=dev).to(torch.bfloat16)
    tail_fwd = graph_ms(lambda: rt.rgb_beta_tail(trunk, tg, tb), iters=20)
    tail_bwd = graph_ms(lambda: rt.vjp_of_plain(rt.rgb_beta_tail_reference, (True, True, True), (trunk, tg, tb),
                                                g_out), iters=20)
    tail_bwd_eager = cuda_ms(lambda: rt.vjp_of_plain(rt.rgb_beta_tail_reference, (True, True, True),
                                                     (trunk, tg, tb), g_out), 50)
    kernel_bwd = graph_ms(lambda: rt._launch_bwd(g_out, trunk, tg, tb), iters=20)
    kernel_bwd_eager = cuda_ms(lambda: rt._launch_bwd(g_out, trunk, tg, tb), 50)
    training["rgb_beta_tail_bf16_batch16"] = {"kernel_ms": tail_fwd, "plain_vjp_backward_ms": tail_bwd,
                                              "plain_vjp_backward_eager_ms": tail_bwd_eager,
                                              "kernel_backward_ms": kernel_bwd,
                                              "kernel_backward_eager_ms": kernel_bwd_eager}
    log(f"[time] rgb_beta_tail_bf16 at a bf16 training step's batch of 16: kernel {tail_fwd:.5f} ms; its backward "
        f"kernels {kernel_bwd:.5f} ms device time (CUDA graph), {kernel_bwd_eager:.5f} ms eager; the plain VJP in bf16 "
        f"they replace {tail_bwd:.5f} ms device time, {tail_bwd_eager:.5f} ms eager ({smi})")

    log(f"[phase] 8 starts at {time.perf_counter() - started:.1f} s")
    # 8. Multi-device training: subprocesses, counts read from their output
    t0 = time.perf_counter()
    dp_launches, dp_times = drive_data_parallel(root, smi)
    dp_times["phase_s"] = time.perf_counter() - t0
    log(f"[dp] launches on the data-parallel paths {dp_launches}; phase 8 took {dp_times['phase_s']:.1f} s")

    for entry in entries:
        entry["dp_launches"] = dp_launches.get(entry["name"], 0)
        entry.update(route="cuda", launches=main_launches[entry["name"]],
                     api_launches=api_launches[entry["name"]],
                     serving_launches=serving_launches[entry["name"]],
                     training_bf16_launches=training_launches[entry["name"]],
                     training_captured_launches=captured_launches[entry["name"]],
                     eval_launches=eval_launches[entry["name"]],
                     max_abs_err=worst[entry["name"]], library_ms=entry.get("library_ms"))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"strokes": strokes, "paint_stroke_p50_ms": strokes["IAN_simple"]["captured"]["p50_ms"],
                    "paint_stroke_p95_ms": strokes["IAN_simple"]["captured"]["p95_ms"],
                    "encode_decode_imgs_per_s_b128": rates["IAN_simple"],
                    "ianv1_encode_decode_imgs_per_s_b128": rates["IANv1"],
                    "ian_encode_decode_imgs_per_s_b128": rates["IAN per-op MDBLOCKs"],
                    "ian_fused_encode_decode_imgs_per_s_b128": rates["IAN fused MDBLOCKs"],
                    "training": training, "rgb_beta_tail_launches_per_g_and_d_step": tail_step_launches,
                    "serving": serve_times, "api": api_times, "editor_first_calls": first_calls,
                    "evaluation": eval_times,
                    "bf16": bf16_times, "data_parallel": dp_times,
                    "wall_s": time.perf_counter() - started}))
    log(f"[time] chip_smoke.py wall time {time.perf_counter() - started:.1f} s ({smi})")
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(inference_mode_trap() if sys.argv[1:] == ["--trap"] else main())
