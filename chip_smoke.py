"""Smoke run of npe_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of the repository

It builds the port's CUDA kernels from `npe_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the Neural Photo
Editor's edit path (IAN_simple at full width, seeded random weights) through
`EditSession` and the model API, holds the card's results against the port
on the CPU, and times the edit step, the kernel and encode+decode. The last
line is {"ok": true, "device": {...}}; any failed phase ends the run with a
nonzero exit before it. Without a CUDA device it exits nonzero at once.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

KERNEL_TOL = 1e-5  # kernel vs plain version on the card, max abs
# Card vs CPU: the golden tolerance of the JAX package's tests. The float32
# sums run in other orders on the two devices (TF32 is off).
RTOL, ATOL = 1e-3, 1e-4
UINT8_STEP = 2.0 / 255.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
N_STROKES = 16
TIMED_STROKES = 200


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


def run_session_script(session, image, z_grid):
    """The main path. Returns the number of composite steps it took (each
    stroke and set_latents composite unless the session shows a sample;
    scroll_patch never does) and the state after the strokes: (Z, IM, RECON)
    as numpy. (At the end, undo has restored the exact z_grid of
    set_latents.)"""
    composites = 0
    session.infer(image)
    for stroke in stroke_script():
        composites += not session.sample_flag
        session.paint_stroke(*stroke)
    painted = (session.Z.cpu().numpy(), session.IM, session.RECON)
    session.scroll_patch(20, 20, 36, 36, +1, 0.5)  # shows the raw decode
    composites += not session.sample_flag  # for set_latents, next
    session.set_latents(z_grid)
    session.sample(11)
    session.undo()
    return composites, painted


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
    from npe_tpu_torch.models import ian_simple
    from npe_tpu_torch.ops.kernels import build
    from npe_tpu_torch.ops.kernels import edit_tail as et
    from npe_tpu_torch.utils.checkpoints import from_reference, save_weights, to_reference, unit_gain
    from npe_tpu_torch.utils.timing import cuda_ms, graph_ms

    # 1. Device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi name, power.limit: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. Build
    for name in build.kernel_names():
        t0 = time.perf_counter()
        out = build.build(name)
        log(f"[build] {name} in {time.perf_counter() - t0:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. Kernel check: kernel vs plain version on the card
    dev = torch.device("cuda")
    worst = 0.0
    for batch in (1, 8):
        for sigma in (0.7, 1.5):
            for mask_kind in (None, "zeros", "random", "ones"):
                xh, recon, err, um = edit_tail_inputs(batch, mask_kind, 1, dev)
                got = et.edit_tail(xh, recon, err, um, sigma)
                torch.cuda.synchronize()
                want = et.edit_tail_reference(xh, recon, err, et.blur_matrix(64, sigma, device=dev), um)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                worst = max(worst, e)
                log(f"[kernel] edit_tail batch {batch} sigma {sigma} user_mask {mask_kind}: "
                    f"max abs err {e:.3e} (tol {KERNEL_TOL})")
                assert e <= KERNEL_TOL, f"edit_tail disagrees with its plain version: {e}"

    # 4. Main path: the edit session on the card, then the same on the CPU
    # seeded weights at unit gain, so the card-vs-CPU comparisons are not a
    # match of near-zero activations
    seeded = ian_simple.init(torch.Generator().manual_seed(0), "cpu")
    variables = from_reference(unit_gain(to_reference(seeded)), dev)
    n_params = sum(v.numel() for k, v in variables.items() if not k.endswith((".mean", ".inv_std")))
    rng = np.random.RandomState(3)
    image = (rng.rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.8
    z_grid = rng.randn(10, 10).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "IAN_simple.npz")
        save_weights(path, variables)
        card = EditSession("IAN_simple", weights_path=path, device="cuda")
        cpu = EditSession("IAN_simple", weights_path=path, device="cpu")
    log(f"[main] IAN_simple full width, {n_params} parameters, weights through save/load_weights")

    et.edit_tail.launches = 0
    t0 = time.perf_counter()
    composites, card_painted = run_session_script(card, image, z_grid)
    torch.cuda.synchronize()
    launches = et.edit_tail.launches
    log(f"[main] card script: {time.perf_counter() - t0:.3f} s; edit_tail launches {launches}, "
        f"composite steps {composites}")
    assert launches == composites, "edit_tail was not launched once per composite step"
    assert launches > 0

    _, cpu_painted = run_session_script(cpu, image, z_grid)
    for name in ("IM", "DELTA", "RECON", "ERROR", "USER_MASK"):
        assert np.isfinite(getattr(card, name)).all(), f"{name} is not finite"
    assert all(np.isfinite(a).all() for a in card_painted)
    (z_a, im_a, recon_a), (z_b, im_b, recon_b) = card_painted, cpu_painted
    check_close("Z after 16 strokes, card vs cpu", z_a, z_b)
    check_recon_close("RECON card vs cpu", recon_a, recon_b)
    check_im_close("IM after 16 strokes, card vs cpu", im_a, im_b, recon_a, recon_b)
    check_im_close("IM at the end, card vs cpu", card.IM, cpu.IM, card.RECON, cpu.RECON)
    assert len(card._undo) == len(cpu._undo) and card.sample_flag == cpu.sample_flag

    # 5. API
    ian_card = IAN("IAN_simple", variables=card.variables, device="cuda")
    ian_cpu = IAN("IAN_simple", variables=cpu.variables, device="cpu")
    x64 = rng.uniform(-1, 1, (64, 3, 64, 64)).astype(np.float32)
    z_card = ian_card.encode_images(x64)
    assert z_card.shape == (64, 100) and np.isfinite(z_card).all()
    check_close("encode_images b64 card vs cpu", z_card, ian_cpu.encode_images(x64))
    img_card = ian_card.sample_at(z_card)
    assert img_card.shape == (64, 3, 64, 64) and np.isfinite(img_card).all()
    check_close("sample_at b64 card vs cpu", img_card, ian_cpu.sample_at(z_card))
    z1 = z_card[:1]
    check_close("imgrad card vs cpu", ian_card.imgrad(8, 8, 24, 24, z1), ian_cpu.imgrad(8, 8, 24, 24, z1))
    rgb = np.broadcast_to(np.float32([0.5, -0.5, 0.2])[None, :, None, None], (1, 3, 64, 64))
    check_close("imgradRGB card vs cpu", ian_card.imgradRGB(8, 8, 24, 24, rgb, z1),
                ian_cpu.imgradRGB(8, 8, 24, 24, rgb, z1))

    # 6. Times
    card.infer(image)
    strokes = stroke_script()
    for i in range(10):
        card.paint_stroke(*strokes[i % N_STROKES])
    times = []
    for i in range(TIMED_STROKES):
        t = time.perf_counter()
        card.paint_stroke(*strokes[i % N_STROKES])  # ends in a device-to-host copy
        times.append((time.perf_counter() - t) * 1e3)
    p50, p95 = np.percentile(times, [50, 95])
    log(f"[time] paint_stroke over {TIMED_STROKES} strokes: p50 {p50:.4f} ms, p95 {p95:.4f} ms "
        f"({smi})")

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(20):
            card.paint_stroke(*strokes[i % N_STROKES])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy > 0:
        log(f"[time] profiler, 20 strokes: wall {wall:.3f} ms, device kernels {busy:.3f} ms "
            f"(idle share {1 - busy / wall:.3f}); kernels by device time:")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            log(f"[time]   {e.self_device_time_total / 20:9.2f} us/stroke  {e.count / 20:5.1f}x  {e.key[:90]}")
    else:
        log("[time] profiler: no device time recorded (idle share not measured)")

    xh, recon, err, um = edit_tail_inputs(1, "random", 2, dev)
    _, radius = et.gaussian_kernel_1d(0.7)
    bm = et.blur_matrix(64, 0.7, device=dev)
    kernel_ms = graph_ms(lambda: et.edit_tail(xh, recon, err, um, 0.7))
    plain_ms = graph_ms(lambda: et.edit_tail_reference(xh, recon, err, bm, um))
    bound_ms, bound_by = edit_tail_bound_ms(1, 64, radius)
    log(f"[time] edit_tail batch 1, device time (CUDA graph): kernel {kernel_ms:.5f} ms, "
        f"plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) ({smi})")
    loop_k = cuda_ms(lambda: et.edit_tail(xh, recon, err, um, 0.7), 2000)
    loop_p = cuda_ms(lambda: et.edit_tail_reference(xh, recon, err, bm, um), 2000)
    log(f"[time] edit_tail batch 1, eager calls back to back: wrapper {loop_k:.5f} ms, "
        f"plain {loop_p:.5f} ms per call")
    xh8, recon8, err8, um8 = edit_tail_inputs(8, "random", 2, dev)
    k8 = graph_ms(lambda: et.edit_tail(xh8, recon8, err8, um8, 0.7))
    log(f"[time] edit_tail batch 8, device time: kernel {k8:.5f} ms, "
        f"bound {edit_tail_bound_ms(8, 64, radius)[0]:.6f} ms")

    x128 = torch.from_numpy(rng.uniform(-1, 1, (128, 3, 64, 64)).astype(np.float32)).to(dev)
    v = card.variables

    def enc_dec():
        with torch.no_grad():
            ian_simple.decode(v, ian_simple.encode(v, x128))

    ed_ms = cuda_ms(enc_dec, 20)
    log(f"[time] encode+decode batch 128: {ed_ms:.4f} ms/batch, {128e3 / ed_ms:.1f} imgs/s ({smi})")

    log(json.dumps({"kernels": [{
        "name": "edit_tail",
        "route": "cuda",
        "source": et.SOURCE,
        "replaces": et.REPLACES,
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"paint_stroke_p50_ms": p50, "paint_stroke_p95_ms": p95,
                    "encode_decode_imgs_per_s_b128": 128e3 / ed_ms}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
