"""Smoke run of npe_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of the repository

It builds the port's CUDA kernels from `npe_tpu_torch/csrc/` (one nvcc per
source, all at once), holds each against its plain PyTorch version on the
card, drives the Neural Photo Editor's edit path through `EditSession` and
the model API on IAN_simple and on IANv1 (full width, seeded random weights
at unit gain; IANv1 with the RGB-Beta head in both kernel forms), holds the
card's results against the port on the CPU, and times the edit step, the
kernels and encode+decode. The last line is {"ok": true, "device": {...}}; any failed phase ends the run with a
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
from torch.autograd import DeviceType

KERNEL_TOL = 1e-5  # kernel vs plain version on the card, max abs
# rgb_beta_head's trunk adds 9 * 16 * C = 9216 products per output in another
# order than cuDNN's conv does, before the sigmoids and the Beta mean's division.
HEAD_TOL = 5e-5
# Card vs CPU: the golden tolerance of the JAX package's tests. The float32
# sums run in other orders on the two devices (TF32 is off).
RTOL, ATOL = 1e-3, 1e-4
UINT8_STEP = 2.0 / 255.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
N_STROKES = 16
TIMED_STROKES = 200
HEAD_SCALES = [2, 3, 4]


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
    """Seeded O(1) decoder features and trunk pre-activations, and tap
    matrices at unit gain (a pre-activation sums 9 * in products, of which a
    9x9 composed kernel at r = 4 fills about a quarter)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, channels, 64, 64).astype(np.float32)
    tr = (rng.randn(9, 16 * channels, 96) / np.sqrt(9 * 16 * channels)).astype(np.float32)
    trunk = rng.randn(batch, 96, 16, 16).astype(np.float32)
    tg = (rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)
    tb = (rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, tr, trunk, tg, tb)]


def roofline_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
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


def rgb_beta_head_bound_ms(batch, channels, cells=256, rr=16):
    """Least time for rgb_beta_head: x and the three tap tensors read once,
    the image written once; the trunk's 9 * 16C * 96 multiply-adds per cell
    on top of the tail's operations."""
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


def time_strokes(label, session, image, smi):
    """p50 / p95 of paint_stroke over TIMED_STROKES strokes on the host's
    clock (each ends in a device-to-host copy)."""
    session.infer(image)
    strokes = stroke_script()
    for i in range(10):
        session.paint_stroke(*strokes[i % N_STROKES])
    times = []
    for i in range(TIMED_STROKES):
        t = time.perf_counter()
        session.paint_stroke(*strokes[i % N_STROKES])
        times.append((time.perf_counter() - t) * 1e3)
    p50, p95 = np.percentile(times, [50, 95])
    log(f"[time] {label} paint_stroke over {TIMED_STROKES} strokes: p50 {p50:.4f} ms, "
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
    from npe_tpu_torch.models import common, ian_simple, ian_v1
    from npe_tpu_torch.ops.kernels import build
    from npe_tpu_torch.ops.kernels import edit_tail as et
    from npe_tpu_torch.ops.kernels import rgb_beta_head as rh
    from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
    from npe_tpu_torch.utils.checkpoints import from_reference, save_weights, to_reference, unit_gain
    from npe_tpu_torch.utils.timing import cuda_ms, graph_ms

    # 1. Device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi name, power.limit: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. Build: one nvcc per source, all started together
    names = build.kernel_names()
    assert names == ["edit_tail", "rgb_beta_head", "rgb_beta_tail"], names
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
    worst = {"edit_tail": 0.0, "rgb_beta_tail": 0.0, "rgb_beta_head": 0.0}
    for batch in (1, 8):
        for sigma in (0.7, 1.5):
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

    def check_kernel(name, case, kernel, plain, args, tol):
        """Forward, and the gradient of sum(out^2) through the wrapper's
        autograd.Function, against the plain version's on the same inputs."""
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
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {case} gradient")
        log(f"[kernel] {name} {case}: gradients of {len(leaves)} inputs within rtol {RTOL}, atol {ATOL}; "
            f"max abs diff {max(max_err(g.cpu(), w.cpu()) for g, w in zip(got_g, want_g)):.3e}")

    for batch in (1, 8):
        _, _, trunk, tg, tb = head_inputs(batch, 64, 10 + batch, dev)
        check_kernel("rgb_beta_tail", f"batch {batch}", rt.rgb_beta_tail, rt.rgb_beta_tail_reference,
                     (trunk, tg, tb), KERNEL_TOL)
    for batch in (1, 2):
        x, tr, _, tg, tb = head_inputs(batch, 64, 20 + batch, dev)
        check_kernel("rgb_beta_head", f"C 64 batch {batch}", rh.rgb_beta_head,
                     rh.rgb_beta_head_reference_packed, (x, tr, tg, tb), HEAD_TOL)

    # 4. Main path: the edit session on the card, then the same on the CPU;
    # seeded weights at unit gain, so the card-vs-CPU comparisons are not a
    # match of near-zero activations
    rng = np.random.RandomState(3)
    image = (rng.rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.8
    z_grid = rng.randn(10, 10).astype(np.float32)
    counters = {"edit_tail": et.edit_tail, "rgb_beta_tail": rt.rgb_beta_tail, "rgb_beta_head": rh.rgb_beta_head}

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
        'composites', 'decodes' or 0."""
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        composites, decodes, card_painted = run_session_script(card, image, z_grid, **script)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        log(f"[main] {label} card script: {time.perf_counter() - t0:.3f} s; composite steps {composites}, "
            f"decodes {decodes}; launches {launches}")
        for name, what in expect.items():
            want = {"composites": composites, "decodes": decodes, 0: 0}[what]
            assert launches[name] == want, f"{label}: {name} launched {launches[name]} times, not {want}"
            assert what == 0 or launches[name] > 0
        _, _, cpu_painted = run_session_script(cpu, image, z_grid, **script)
        assert launches == {name: fn.launches for name, fn in counters.items()}  # the CPU launches nothing
        compare_sessions(label, card, cpu, card_painted, cpu_painted)
        return launches

    card, cpu = sessions_of("IAN_simple", ian_simple)
    main_launches = drive("IAN_simple", card, cpu,
                          {"edit_tail": "composites", "rgb_beta_tail": 0, "rgb_beta_head": 0})

    assert common.HEAD_MODE == "hybrid"
    card_v1, cpu_v1 = sessions_of("IANv1", ian_v1)
    masks = [k for k in card_v1.variables if k.endswith(".weights_mask")]
    assert len(masks) == 6 and all(card_v1.variables[k].is_cuda for k in masks)
    hybrid_launches = drive("IANv1 hybrid head", card_v1, cpu_v1,
                            {"edit_tail": "composites", "rgb_beta_tail": "decodes", "rgb_beta_head": 0})
    main_launches["rgb_beta_tail"] = hybrid_launches["rgb_beta_tail"]
    fused_v1, fused_cpu_v1 = (EditSession("IANv1", variables=s.variables, device=s.device, head_mode="fused")
                              for s in (card_v1, cpu_v1))
    fused_launches = drive("IANv1 fused head", fused_v1, fused_cpu_v1,
                           {"edit_tail": "composites", "rgb_beta_tail": 0, "rgb_beta_head": "decodes"},
                           n_strokes=4, tail=False)
    main_launches["rgb_beta_head"] = fused_launches["rgb_beta_head"]

    # 5. API
    compare_api("IAN_simple", IAN("IAN_simple", variables=card.variables, device="cuda"),
                IAN("IAN_simple", variables=cpu.variables, device="cpu"), rng)
    compare_api("IANv1", IAN("IANv1", variables=card_v1.variables, device="cuda"),
                IAN("IANv1", variables=cpu_v1.variables, device="cpu"), rng)

    # 6. Times
    p50, p95 = time_strokes("IAN_simple", card, image, smi)
    profile_strokes("IAN_simple", card, top=12)
    v1_p50, v1_p95 = time_strokes("IANv1 hybrid head", card_v1, image, smi)
    v1_busy = profile_strokes("IANv1 hybrid head", card_v1, top=16)
    fused_p50, fused_p95 = time_strokes("IANv1 fused head", fused_v1, image, smi)
    fused_busy = profile_strokes("IANv1 fused head", fused_v1, top=6)

    # what the head's weight packing costs on every decode (two a stroke)
    v1 = card_v1.variables
    for as_taps, form in ((False, "hybrid"), (True, "fused")):
        pack = lambda: common.packed_head_weights(v1, HEAD_SCALES, 4, as_taps)  # noqa: E731
        log(f"[time] head weight packing, {form} form, per decode: {cuda_ms(pack, 200):.4f} ms eager back "
            f"to back (host-bound), {graph_ms(pack, iters=20):.4f} ms device time (CUDA graph)")

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
    entries = [{"name": "edit_tail", "source": et.SOURCE, "replaces": et.REPLACES, "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}]

    for batch in (1, 8):
        x, tr, trunk, tg, tb = head_inputs(batch, 64, 30 + batch, dev)
        for name, mod, kernel, plain, args, bound in (
            ("rgb_beta_tail", rt, rt.rgb_beta_tail, rt.rgb_beta_tail_reference, (trunk, tg, tb),
             rgb_beta_tail_bound_ms(batch)),
            ("rgb_beta_head", rh, rh.rgb_beta_head, rh.rgb_beta_head_reference_packed, (x, tr, tg, tb),
             rgb_beta_head_bound_ms(batch, 64)),
        ):
            with torch.no_grad():
                k_ms = graph_ms(lambda: kernel(*args), iters=50)
                p_ms = graph_ms(lambda: plain(*args), iters=50)
            log(f"[time] {name} batch {batch}, device time (CUDA graph): kernel {k_ms:.5f} ms, "
                f"plain {p_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}) ({smi})")
            if batch == 1:
                entries.append({"name": name, "source": mod.SOURCE, "replaces": mod.REPLACES, "ms": k_ms,
                                "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1]})
    # the whole head from the weights: both kernel forms, and the all-library
    # alternative to them, the fused kernel's plain version ("packed")
    h1 = torch.from_numpy(rng.randn(1, 64, 64, 64).astype(np.float32)).to(dev)
    forms = {
        "packed": lambda: rh.rgb_beta_head_reference_packed(
            h1, *common.packed_head_weights(v1, HEAD_SCALES, 4, as_taps=True)),
        "hybrid": lambda: common.rgb_beta_head(v1, h1, HEAD_SCALES, mode="hybrid"),
        "fused": lambda: common.rgb_beta_head(v1, h1, HEAD_SCALES, mode="fused"),
    }
    with torch.no_grad():
        for form, fn in forms.items():
            log(f"[time] whole head, {form} form, batch 1, weight packing included, device time "
                f"(CUDA graph): {graph_ms(fn, iters=20):.5f} ms ({smi})")

    x128 = torch.from_numpy(rng.uniform(-1, 1, (128, 3, 64, 64)).astype(np.float32)).to(dev)
    rates = {}
    for label, module, v in (("IAN_simple", ian_simple, card.variables), ("IANv1", ian_v1, v1)):
        def enc_dec():
            with torch.no_grad():
                module.decode(v, module.encode(v, x128))

        ed_ms = cuda_ms(enc_dec, 20)
        rates[label] = 128e3 / ed_ms
        log(f"[time] {label} encode+decode batch 128: {ed_ms:.4f} ms/batch, {rates[label]:.1f} imgs/s ({smi})")

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
                    "ianv1_encode_decode_imgs_per_s_b128": rates["IANv1"]}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
