"""Traffic kind "edit": one person at the brush, in a closed loop. A seeded
face is loaded (`EditSession.infer`), then `paint_stroke` runs one stroke
after another, each ending in the download of the shown image, with boxes,
places, colours and sigmas drawn from the seed (a cycle of `cycle` strokes;
every seed draws from the same ranges, so only the order and places move).

Parameters: box_px [lo, hi] (width and height), sigmas (taken in turn),
cycle, warm_strokes (set-up), check_strokes (a seeded uniform sample of the
window's strokes that the reference follows), trace_seconds.

The check follows the program's own state: each sampled stroke starts from
the latents the program held before it (and its RECON, ERROR and user mask),
and the reference's stroke from there is compared with the program's new
latents and shown image. The start that this skips is checked on its own:
the latents `infer` gave the face, and the program's decode of them.
"""

import time

import numpy as np
import torch

from benchmark.reference import editor as ref_editor
from benchmark.reference.models import Model, init
from benchmark.yardstick.compare import Reservoir, abs_gap, rel_gap
from benchmark.yardstick.faces import faces_uint8, seeds, to_tanh

# the percentile of the sampled strokes' gaps that stroke_z and stroke_image hold
STROKE_PERCENTILE = 95


def strokes(traffic, seed, size):
    rng = np.random.default_rng(seed)
    lo, hi = traffic["box_px"]
    out = []
    for i in range(traffic["cycle"]):
        w, h = (int(a) for a in rng.integers(lo, hi + 1, 2))
        x1, y1 = int(rng.integers(0, size - w + 1)), int(rng.integers(0, size - h + 1))
        rgb = tuple(int(c) for c in rng.integers(0, 256, 3))
        out.append((x1, y1, x1 + w, y1 + h, rgb, float(traffic["sigmas"][i % len(traffic["sigmas"])])))
    return out


def setup(run):
    from npe_tpu_torch.editor.engine import EditSession

    cfg, tr = run.config, run.traffic
    run.batch = 1
    s_weights, s_face, s_strokes, s_sample = seeds(run.seed, 4)
    run.variables = init(cfg, s_weights, run.device)
    run.session = EditSession(config=cfg["model"], variables=run.variables, dim=tuple(cfg["latent_grid"]),
                              device=run.device, **cfg["forms"])
    run.face = to_tanh(faces_uint8(1, s_face, run.device))[0].cpu().numpy()
    run.session.infer(run.face)
    run.start = {"z": run.session.Z, "decoded": run.session.decode_current()}
    run.state = (run.session._recon, run.session._error)
    run.strokes = strokes(tr, s_strokes, cfg["image"][1])
    for i in range(tr["warm_strokes"]):
        run.session.paint_stroke(*run.strokes[-1 - i])
    run.sample = Reservoir(tr["check_strokes"], s_sample)
    run.times = []


def window(run, seconds):
    session, script, sample, times = run.session, run.strokes, run.sample, run.times
    n = len(script)
    start = time.perf_counter()
    end, i = start + seconds, 0
    while True:
        stroke = script[i % n]
        z_before = session.Z
        with run.span("paint_stroke"):
            t0 = time.perf_counter()
            session.paint_stroke(*stroke)
            t1 = time.perf_counter()
        times.append(t1 - t0)
        sample.offer((stroke, z_before, session.USER_MASK, session.Z, session.IM))
        i += 1
        if t1 >= end:
            break
    run.window_s = time.perf_counter() - start
    run.work = i


def release(run):
    del run.session


def end_to_end(run):
    return {"stroke_ms_p95": float(np.percentile(np.asarray(run.times) * 1e3, 95))}


def readings(run, subject):
    """The numbers compared: subject "program" reads the program's outputs,
    "control" the reference's in TF32 from the same inputs; each against
    the reference in float32. encode_z: the latents `infer` gave the face,
    over their largest; decode_image: the program's decode of them, the
    widest gap; stroke_z: of each sampled stroke's step of the latents, the
    widest gap over the step's largest element, and the STROKE_PERCENTILE-th
    percentile of these over the sample; stroke_image: the same of each
    stroke's shown image, its widest gap."""
    cfg, v, dev = run.config, run.variables, run.device
    ref = Model(cfg, "float32")
    sub = Model(cfg, "tf32") if subject == "control" else None
    face = torch.from_numpy(run.face).to(dev)[None]
    z0 = run.start["z"]
    out = {}
    with torch.no_grad():
        want = ref.encode(v, face)[0]
        out["encode_z"] = rel_gap(sub.encode(v, face)[0] if sub else z0, want)
        want = ref.decode(v, z0[None])[0]
        got = sub.decode(v, z0[None])[0] if sub else torch.from_numpy(run.start["decoded"]).to(dev)
        out["decode_image"] = abs_gap(got, want)
    recon, error = run.state
    z_gaps, im_gaps = [], []
    for (x1, y1, x2, y2, rgb, sigma), z_before, user_mask, z_after, shown in run.sample.items:
        rgb_tanh = 2.0 * (np.float32(rgb) / 255.0) - 1.0
        args = (z_before, recon, error, torch.from_numpy(user_mask).to(dev), (x1, y1, x2, y2), sigma, rgb_tanh)
        z_want, im_want, _ = ref_editor.stroke(ref, v, *args)
        if sub:
            z_after, shown, _ = ref_editor.stroke(sub, v, *args)
        else:
            shown = torch.from_numpy(shown).to(dev)
        z_gaps.append(rel_gap(z_after - z_before, z_want - z_before))
        im_gaps.append(abs_gap(shown, im_want))
    # A stroke's gradient crosses every lrelu of the decoder: where the two
    # sides round a pre-activation to opposite sides of zero, the slope, and
    # the gradient near it, differ, in float32 too (PERF.md, "How correct is
    # decided"). So a high percentile of the sampled strokes' gaps is
    # compared, which a fault in four of 64 sampled strokes reaches; the
    # median and the widest are read for the record.
    for name, gaps in (("stroke_z", z_gaps), ("stroke_image", im_gaps)):
        out[name] = float(np.percentile(gaps, STROKE_PERCENTILE))
        out[name + "_median"], out[name + "_widest"] = float(np.median(gaps)), max(gaps)
    return out


def unit_flops(run):
    """Operations of one stroke: the reference's decode, its gradient with
    respect to z, and the second decode, counted on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = run.config
    v = {k: torch.empty(t.shape, device="meta") for k, t in run.variables.items()}
    h, w = cfg["image"][1:]
    z = torch.empty(cfg["num_latents"], device="meta")
    img = torch.empty((h, w, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        ref_editor.stroke(Model(cfg), v, z, img, img, torch.empty((h, w), device="meta"), (0, 0, 4, 4), 0.0,
                          np.zeros(3, np.float32))
    return counter.get_total_flops()
