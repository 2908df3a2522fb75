"""Smoke run of npe_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of the repository

It builds the port's CUDA kernels from `npe_tpu_torch/csrc/` (one nvcc per
source, all at once), holds each against its plain PyTorch version on the
card, drives the Neural Photo Editor's edit path through `EditSession` and
the model API on IAN_simple, on IANv1 and on full IAN (full width, seeded
random weights at unit gain; IANv1 with the RGB-Beta head in both kernel
forms, full IAN with its MDBLOCKs in the fused and the per-op form), holds
the card's results against the port on the CPU, and times the edit step, the
kernels and encode+decode. Then the trainer: `training.train.train` on
IAN_simple at full width (batch 128, the procedural dataset, two epochs and a
resumed third, with the dataset resident on the card and with per-chunk
uploads, each chunk staged by the `staging` kernel), one G and one D step held
against the CPU, the same steps on IANv1 and full IAN, and the training
times. The last line is {"ok": true, "device": {...}}; any failed phase ends the run with a
nonzero exit before it. Without a CUDA device it exits nonzero at once.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

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
# Card vs CPU: the golden tolerance of the JAX package's tests. The float32
# sums run in other orders on the two devices (TF32 is off).
RTOL, ATOL = 1e-3, 1e-4
UINT8_STEP = 2.0 / 255.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
N_STROKES = 16
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
TRAIN_BATCH, TRAIN_BATCHES_PER_CHUNK = 128, 8
TRAIN_EXAMPLES = 2 * TRAIN_BATCHES_PER_CHUNK * TRAIN_BATCH + TRAIN_BATCH // 2  # two chunks at either offset
HEAD_SCALES = [2, 3, 4]
# Full IAN's three MDBLOCKs: (name, channels, map size, scales)
MDBLOCK_SHAPES = (("dec_conv2a", 512, 8, (0, 2)), ("dec_conv3a", 256, 16, (0, 2, 3)),
                  ("dec_conv4a", 128, 32, (0, 2, 3)))


def log(*args):
    print(*args, flush=True)


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


def mdblock_bound_ms(batch, channels, size, scales, route="3xtf32"):
    """Least time for one MDBLOCK: x and both tap tensors and the affines
    read once, the output written once; two MDCLs of H*W*T*C^2 multiply-adds,
    and about ten float32 operations per element for the three affines,
    lrelus and the residual. route "3xtf32", the kernel's: each multiply-add
    is three TF32 products on the tensor cores (two operations each);
    "fp32": one float32 multiply-add outside them."""
    n_taps = 9 * (1 + sum(s > 0 for s in scales))
    px = batch * size * size
    nbytes = 4 * (2 * px * channels + 2 * n_taps * channels * channels + 6 * channels)
    macs = 2 * px * n_taps * channels * channels
    other = 10 * px * channels
    if route == "fp32":
        return roofline_ms(nbytes, 2 * macs + other)
    # the elementwise operations in TF32-rate units, so that one peak divides both
    return roofline_ms(nbytes, 3 * 2 * macs + other * TF32_OPS_PER_S / FP32_OPS_PER_S, TF32_OPS_PER_S)


def roofline_ms(nbytes, flops, peak=FP32_OPS_PER_S):
    """The larger of the bytes over HBM bandwidth and the operations over
    `peak`, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tail_work(batch, cells=256, rr=16):
    """(bytes, float32 operations) of the autoregressive tail: the G_b
    (2rr -> 2rr) and B_b (4rr -> 2rr) tap products at two operations a
    multiply-add, and about ten operations for each sigmoid and Beta mean."""
    nbytes = 4 * (batch * 6 * rr * cells + 9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr + batch * 3 * rr * cells)
    flops = batch * cells * (2 * 9 * (2 * rr * 2 * rr + 4 * rr * 2 * rr) + 10 * 9 * rr)
    return nbytes, flops


def rgb_beta_tail_bound_ms(batch):
    """Least time for rgb_beta_tail on this card: trunk and taps read once,
    the output written once, or its float32 operations, whichever is larger."""
    return roofline_ms(*tail_work(batch))


def rgb_beta_head_bound_ms(batch, channels, cells=256, rr=16, offsets=33):
    """Least time for rgb_beta_head: x and the three tap tensors it is given
    read once, the image written once; the work the function needs, each
    output pixel's MDCLs over their 33 distinct offsets (the trunk C -> 6,
    the tail's G_b 2 -> 2 and B_b 4 -> 2), two operations a multiply-add,
    and about ten operations for each sigmoid and Beta mean."""
    px = batch * cells * rr
    nbytes = 4 * (px * channels + 36 * channels * 6 + 9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr + px * 3)
    flops = px * 2 * offsets * (channels * 6 + 2 * 2 + 4 * 2) + batch * cells * 10 * 9 * rr
    return roofline_ms(nbytes, flops)


def rgb_beta_head_s2d_bound_ms(batch, channels, cells=256, rr=16):
    """The bound of the space-to-depth form the kernel had before its
    direct trunk: the trunk's 9 * 16C * 96 multiply-adds per cell
    (structural zeros included) on top of the tail's s2d operations, and its
    3.5 MB tap tensor. Kept beside `rgb_beta_head_bound_ms`, the work the
    function needs, so that older measurements stay comparable."""
    tail_bytes, tail_flops = tail_work(batch)
    tail_bytes -= 4 * batch * 6 * rr * cells  # the trunk never leaves the kernel
    nbytes = tail_bytes + 4 * (batch * channels * rr * cells + 9 * rr * channels * 6 * rr)
    flops = tail_flops + batch * cells * 2 * 9 * rr * channels * 6 * rr
    return roofline_ms(nbytes, flops)


def stroke_script():
    """16 strokes with varied boxes, colours and sigma in {0, 0.5}."""
    rng = np.random.RandomState(7)
    strokes = []
    for i in range(N_STROKES):
        w, h = rng.randint(4, 21, 2)
        x1, y1 = rng.randint(0, 64 - w), rng.randint(0, 64 - h)
        rgb = tuple(int(c) for c in rng.randint(0, 256, 3))
        strokes.append((int(x1), int(y1), int(x1 + w), int(y1 + h), rgb, 0.5 * (i % 2)))
    return strokes


def run_session_script(session, image, z_grid, n_strokes=N_STROKES, tail=True):
    """The main path. Returns the number of composite steps it took (each
    stroke and set_latents composite unless the session shows a sample;
    scroll_patch never does), the number of decodes (infer, set_latents and
    sample one each, a stroke or a scroll two: one under the gradient, one
    at the new latent) and the state after the strokes: (Z, IM, RECON) as
    numpy. (At the end, undo has restored the exact z_grid of set_latents.)
    `tail=False` leaves out scroll_patch and sample."""
    composites, decodes = 0, 1
    session.infer(image)
    for stroke in stroke_script()[:n_strokes]:
        composites += not session.sample_flag
        decodes += 2
        session.paint_stroke(*stroke)
    painted = (session.Z.cpu().numpy(), session.IM, session.RECON)
    if tail:
        session.scroll_patch(20, 20, 36, 36, +1, 0.5)  # shows the raw decode
        decodes += 2
    composites += not session.sample_flag  # for set_latents, next
    decodes += 1
    session.set_latents(z_grid)
    if tail:
        session.sample(11)
        decodes += 1
    session.undo()
    return composites, decodes, painted


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


def time_strokes(label, session, image, smi, n=TIMED_STROKES):
    """p50 / p95 of paint_stroke over `n` strokes on the host's clock (each
    ends in a device-to-host copy)."""
    session.infer(image)
    strokes = stroke_script()
    for i in range(10):
        session.paint_stroke(*strokes[i % N_STROKES])
    times = []
    for i in range(n):
        t = time.perf_counter()
        session.paint_stroke(*strokes[i % N_STROKES])
        times.append((time.perf_counter() - t) * 1e3)
    p50, p95 = np.percentile(times, [50, 95])
    log(f"[time] {label} paint_stroke over {n} strokes: p50 {p50:.4f} ms, "
        f"p95 {p95:.4f} ms ({smi})")
    return p50, p95


def profile_strokes(label, session, top):
    """torch.profiler over 20 strokes: device time by kernel name and the
    device's idle share. Returns the device kernel time per stroke in ms, or
    None if the profiler recorded no device time."""
    strokes = stroke_script()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(20):
            session.paint_stroke(*strokes[i % N_STROKES])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log(f"[time] {label} profiler: no device time recorded (idle share not measured)")
        return None
    log(f"[time] {label} profiler, 20 strokes: wall {wall:.3f} ms, device kernels {busy:.3f} ms "
        f"(idle share {1 - busy / wall:.3f}); kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[time]   {e.self_device_time_total / 20:9.2f} us/stroke  {e.count / 20:5.1f}x  {e.key[:90]}")
    return busy / 20


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
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state = tt.train(max_epochs=2, **kw)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
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

        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        resumed = tt.train(max_epochs=3, resume=True, device_cache_bytes=0, **kw)
        torch.cuda.synchronize()
        log(f"[train] resumed for a third epoch, chunks sent up from pinned memory: {time.perf_counter() - t0:.2f} s; "
            f"staging launches {counters['staging'].launches}")
        assert counters["staging"].launches == 2
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
    sample), each decode launches rgb_beta_tail once, and the MDBLOCKs take
    the per-op form under training. Frozen weights and masks stay bit-equal."""
    from npe_tpu_torch.training import train_step as ts

    cfg = dict(module.cfg, batch_size=batch_size)
    state0 = ts.init_train_state(module, variables, cfg)
    batch = step_batch(cfg, batch_size, 31, "cuda")
    for fn in counters.values():
        fn.launches = 0
    gen_step, discrim_step = ts.make_train_steps(module, cfg)
    state, m_g = gen_step(state0, *batch, 2e-4)
    state, m_d = discrim_step(state, *batch, 2e-4)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[train] {label} batch {batch_size}, one G and one D step on the card: launches {launches}; "
        f"G pixel_loss {float(m_g['pixel_loss']):.4f}, D discrim_acc {float(m_d['discrim_acc']):.4f}")
    assert launches["rgb_beta_tail"] == 4 and launches["mdblock"] == 0 and launches["rgb_beta_head"] == 0, launches
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


def time_training(label, module, variables, batch_size, batches_per_chunk, smi):
    """ms per G step, per D step and imgs/s over one chunk of alternating
    steps (CUDA events, steady state after one warm chunk), with peak
    device memory."""
    from npe_tpu_torch.training import train_step as ts

    cfg = dict(module.cfg, batch_size=batch_size, batches_per_chunk=batches_per_chunk)
    state = ts.init_train_state(module, variables, cfg)
    n = batch_size * batches_per_chunk
    rng = np.random.RandomState(5)
    x_chunk = torch.from_numpy(rng.uniform(-0.9, 0.9, (n, 3, 64, 64)).astype(np.float32)).cuda()
    gen = torch.Generator("cuda").manual_seed(1)
    chunk_step = ts.make_chunk_step(module, cfg, batches_per_chunk)
    gen_step, discrim_step = ts.make_train_steps(module, cfg)
    batch = step_batch(cfg, batch_size, 33, "cuda")
    torch.cuda.reset_peak_memory_stats()
    state, *_ = chunk_step(state, x_chunk, 0, gen, 2e-4)  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, *_ = chunk_step(state, x_chunk, 0, gen, 2e-4)
    end.record()
    torch.cuda.synchronize()
    chunk_ms = start.elapsed_time(end)
    per_step = {}
    for name, step in (("G", gen_step), ("D", discrim_step)):
        start.record()
        for _ in range(8):
            state, _ = step(state, *batch, 2e-4)
        end.record()
        torch.cuda.synchronize()
        per_step[name] = start.elapsed_time(end) / 8
    peak = torch.cuda.max_memory_allocated() / 2**20
    rate = n / chunk_ms * 1e3
    log(f"[time] {label} training, batch {batch_size}: {per_step['G']:.3f} ms per G step, {per_step['D']:.3f} ms per D "
        f"step, {chunk_ms:.2f} ms per chunk of {batches_per_chunk} alternating steps = {rate:.1f} imgs/s; peak memory "
        f"{peak:.0f} MiB ({smi})")
    return {"g_step_ms": per_step["G"], "d_step_ms": per_step["D"], "imgs_per_s": rate, "peak_mib": peak}, state


def profile_training(label, module, state, batch_size, top):
    """torch.profiler over 8 alternating steps: device kernel time, the
    device's idle share and the top kernels by name."""
    from npe_tpu_torch.training import train_step as ts

    cfg = dict(module.cfg, batch_size=batch_size)
    steps = ts.make_train_steps(module, cfg)
    batch = step_batch(cfg, batch_size, 35, "cuda")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(8):
            state, _ = steps[i % 2](state, *batch, 2e-4)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log(f"[time] {label} training profiler: no device time recorded (idle share not measured)")
        return None, None
    log(f"[time] {label} training profiler, 8 steps under the profiler: wall {wall:.2f} ms, device kernels {busy:.2f} ms "
        f"(idle share {1 - busy / wall:.3f}); kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[time]   {e.self_device_time_total / 8e3:9.3f} ms/step  {e.count / 8:6.1f}x  {e.key[:90]}")
    return busy / 8, 1 - busy / wall


def main():
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
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import launch_floor  # scripts/launch_floor.py: the empty kernel edit_tail is read beside

    # 1. Device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi name, power.limit: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. Build: one nvcc per source, all started together
    names = build.kernel_names()
    assert names == ["edit_tail", "mdblock", "rgb_beta_head", "rgb_beta_tail", "staging"], names
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        outputs = list(pool.map(build.build, names))
    log(f"[build] {len(names)} kernels in parallel in {time.perf_counter() - t0:.2f} s")
    for name, out in zip(names, outputs):
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. Kernel checks: each kernel vs its plain version on the card
    dev = torch.device("cuda")
    worst = {"edit_tail": 0.0, "rgb_beta_tail": 0.0, "rgb_beta_head": 0.0, "mdblock": 0.0, "staging": 0.0}
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

    def check_kernel(name, case, kernel, plain, args, tol, grad_atol_of_largest=False):
        """Forward, and the gradient of sum(out^2) through the wrapper's
        autograd.Function, against the plain version's on the same inputs.
        `grad_atol_of_largest`: ATOL times each gradient's largest value, for
        gradients that are sums over every pixel and reach several hundred."""
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        e = float((got - want).abs().max())
        worst[name] = max(worst[name], e)
        log(f"[kernel] {name} {case}: max abs err {e:.3e} (tol {tol}), output std {float(want.std()):.3f}")
        assert got.shape == want.shape and e <= tol, f"{name} disagrees with its plain version: {e}"
        leaves = [a.clone().requires_grad_(True) for a in args]
        got_g = torch.autograd.grad((kernel(*leaves) ** 2).sum(), leaves)
        want_g = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
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
    for _, channels, size, scales in MDBLOCK_SHAPES:
        for batch in (1, 8):
            check_kernel("mdblock", f"{size}x{size}x{channels} scales {list(scales)} batch {batch}",
                         lambda *a: mk.mdblock_fused(*a, scales),  # noqa: B023
                         lambda *a: mk.mdblock_taps_reference(*a, scales),  # noqa: B023
                         mdblock_inputs(batch, channels, size, scales, 40 + batch, dev), MDBLOCK_TOL,
                         grad_atol_of_largest=True)

    staging_cache = check_staging(staging, dev, worst)

    # 4. Main path: the edit session on the card, then the same on the CPU;
    # seeded weights at unit gain, so the card-vs-CPU comparisons are not a
    # match of near-zero activations
    rng = np.random.RandomState(3)
    image = (rng.rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.8
    z_grid = rng.randn(10, 10).astype(np.float32)
    counters = {"edit_tail": et.edit_tail, "rgb_beta_tail": rt.rgb_beta_tail, "rgb_beta_head": rh.rgb_beta_head,
                "mdblock": mk.mdblock_fused, "staging": staging.stage_chunk}

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
        """Counts to 0, the script on the card, counts read; then the same
        script on the CPU and the comparison. `expect` maps each kernel to
        'composites', 'decodes', '3 x decodes' or 0."""
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        composites, decodes, card_painted = run_session_script(card, image, z_grid, **script)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        log(f"[main] {label} card script: {time.perf_counter() - t0:.3f} s; composite steps {composites}, "
            f"decodes {decodes}; launches {launches}")
        for name, what in expect.items():
            want = {"composites": composites, "decodes": decodes, "3 x decodes": 3 * decodes, 0: 0}[what]
            assert launches[name] == want, f"{label}: {name} launched {launches[name]} times, not {want}"
            assert what == 0 or launches[name] > 0
        _, _, cpu_painted = run_session_script(cpu, image, z_grid, **script)
        assert launches == {name: fn.launches for name, fn in counters.items()}  # the CPU launches nothing
        compare_sessions(label, card, cpu, card_painted, cpu_painted)
        return launches

    card, cpu = sessions_of("IAN_simple", ian_simple)
    main_launches = drive("IAN_simple", card, cpu,
                          {"edit_tail": "composites", "rgb_beta_tail": 0, "rgb_beta_head": 0, "mdblock": 0,
                           "staging": 0})

    assert common.HEAD_MODE == "hybrid"
    card_v1, cpu_v1 = sessions_of("IANv1", ian_v1)
    masks = [k for k in card_v1.variables if k.endswith(".weights_mask")]
    assert len(masks) == 6 and all(card_v1.variables[k].is_cuda for k in masks)
    hybrid_launches = drive("IANv1 hybrid head", card_v1, cpu_v1,
                            {"edit_tail": "composites", "rgb_beta_tail": "decodes", "rgb_beta_head": 0,
                             "mdblock": 0})
    main_launches["rgb_beta_tail"] = hybrid_launches["rgb_beta_tail"]
    fused_v1, fused_cpu_v1 = (EditSession("IANv1", variables=s.variables, device=s.device, head_mode="fused")
                              for s in (card_v1, cpu_v1))
    fused_launches = drive("IANv1 fused head", fused_v1, fused_cpu_v1,
                           {"edit_tail": "composites", "rgb_beta_tail": 0, "rgb_beta_head": "decodes"},
                           n_strokes=4, tail=False)
    main_launches["rgb_beta_head"] = fused_launches["rgb_beta_head"]

    # full IAN: the whole script with the three MDBLOCKs in the kernel's form,
    # a short one in the default per-op form, which must not reach the kernel
    assert common.MDBLOCK_MODE == "plain"
    card_ian, cpu_ian = sessions_of("IAN", ian)
    fused_ian, fused_cpu_ian = (EditSession("IAN", variables=s.variables, device=s.device, mdblock_mode="fused")
                                for s in (card_ian, cpu_ian))
    ian_launches = drive("IAN fused MDBLOCKs", fused_ian, fused_cpu_ian,
                         {"edit_tail": "composites", "rgb_beta_tail": "decodes", "rgb_beta_head": 0,
                          "mdblock": "3 x decodes"})
    main_launches["mdblock"] = ian_launches["mdblock"]
    drive("IAN per-op MDBLOCKs", card_ian, cpu_ian,
          {"edit_tail": "composites", "rgb_beta_tail": "decodes", "rgb_beta_head": 0, "mdblock": 0},
          n_strokes=4, tail=False)

    # 5. API
    compare_api("IAN_simple", IAN("IAN_simple", variables=card.variables, device="cuda"),
                IAN("IAN_simple", variables=cpu.variables, device="cpu"), rng)
    compare_api("IANv1", IAN("IANv1", variables=card_v1.variables, device="cuda"),
                IAN("IANv1", variables=cpu_v1.variables, device="cpu"), rng)
    # the kernel's form on the card against the per-op form (library convs) on the CPU
    compare_api("IAN, card fused vs cpu per-op",
                IAN("IAN", variables=card_ian.variables, device="cuda", mdblock_mode="fused"),
                IAN("IAN", variables=cpu_ian.variables, device="cpu"), rng)

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

    # 7. Times
    p50, p95 = time_strokes("IAN_simple", card, image, smi)
    profile_strokes("IAN_simple", card, top=12)
    v1_p50, v1_p95 = time_strokes("IANv1 hybrid head", card_v1, image, smi)
    v1_busy = profile_strokes("IANv1 hybrid head", card_v1, top=16)
    fused_p50, fused_p95 = time_strokes("IANv1 fused head", fused_v1, image, smi)
    fused_busy = profile_strokes("IANv1 fused head", fused_v1, top=6)
    ian_p50, ian_p95 = time_strokes("IAN per-op MDBLOCKs", card_ian, image, smi)
    ian_busy = profile_strokes("IAN per-op MDBLOCKs", card_ian, top=14)
    ian_fused_p50, ian_fused_p95 = time_strokes("IAN fused MDBLOCKs", fused_ian, image, smi, n=50)
    ian_fused_busy = profile_strokes("IAN fused MDBLOCKs", fused_ian, top=14)

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

    # training: seeded default-init weights on the card (what `train` starts from)
    training = {}
    for label, module, batch_size, bpc in (("IAN_simple", ian_simple, 128, 8), ("IANv1", ian_v1, 16, 16),
                                           ("IAN", ian, 16, 16)):
        fresh = module.init(torch.Generator().manual_seed(0), "cuda")
        training[label], trained = time_training(label, module, fresh, batch_size, bpc, smi)
        busy, idle = profile_training(label, module, trained, batch_size, top=14 if label == "IAN_simple" else 8)
        training[label].update(device_ms_per_step=busy, idle_share=idle)
        if label == "IAN_simple":
            # PyTorch's own default lets cuDNN run float32 convolutions in TF32
            torch.backends.cudnn.allow_tf32 = True
            training["IAN_simple, cuDNN TF32 on"], _ = time_training("IAN_simple, cuDNN TF32 on", module, fresh,
                                                                     batch_size, bpc, smi)
            torch.backends.cudnn.allow_tf32 = False
        del fresh, trained

    for entry in entries:
        entry.update(route="cuda", launches=main_launches[entry["name"]],
                     max_abs_err=worst[entry["name"]], library_ms=None)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"paint_stroke_p50_ms": p50, "paint_stroke_p95_ms": p95,
                    "encode_decode_imgs_per_s_b128": rates["IAN_simple"],
                    "ianv1_paint_stroke_p50_ms": v1_p50, "ianv1_paint_stroke_p95_ms": v1_p95,
                    "ianv1_device_ms_per_stroke": v1_busy,
                    "ianv1_fused_paint_stroke_p50_ms": fused_p50, "ianv1_fused_paint_stroke_p95_ms": fused_p95,
                    "ianv1_fused_device_ms_per_stroke": fused_busy,
                    "ianv1_encode_decode_imgs_per_s_b128": rates["IANv1"],
                    "ian_paint_stroke_p50_ms": ian_p50, "ian_paint_stroke_p95_ms": ian_p95,
                    "ian_device_ms_per_stroke": ian_busy,
                    "ian_fused_paint_stroke_p50_ms": ian_fused_p50, "ian_fused_paint_stroke_p95_ms": ian_fused_p95,
                    "ian_fused_device_ms_per_stroke": ian_fused_busy,
                    "ian_encode_decode_imgs_per_s_b128": rates["IAN per-op MDBLOCKs"],
                    "ian_fused_encode_decode_imgs_per_s_b128": rates["IAN fused MDBLOCKs"],
                    "training": training, "rgb_beta_tail_launches_per_g_and_d_step": tail_step_launches}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
