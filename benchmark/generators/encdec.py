"""Traffic kind "encdec": a caller of the model API with batches of images
on the host, in a closed loop: `api.IAN.encode_images` of a batch of seeded
faces, then `sample_at` of the latents it returned, back to back, host
arrays in and out, one batch after another.

Parameters: batch, pool_batches (distinct host batches, taken in a seeded
order), check_batches (a seeded uniform sample of the window's batches that
the reference encodes and decodes again), trace_seconds.
"""

import time

import numpy as np
import torch

from benchmark.reference.models import Model, init
from benchmark.yardstick.compare import Reservoir, abs_gap, rel_gap
from benchmark.yardstick.faces import faces_uint8, seeds, to_tanh


def setup(run):
    from npe_tpu_torch.api import IAN

    cfg, tr = run.config, run.traffic
    run.batch = tr["batch"]
    s_weights, s_faces, s_order, s_sample = seeds(run.seed, 4)
    run.variables = init(cfg, s_weights, run.device)
    run.api = IAN(config_path=cfg["model"], variables=run.variables, device=run.device, **cfg["forms"])
    b, n = tr["batch"], tr["pool_batches"]
    pool = to_tanh(faces_uint8(b * n, s_faces, run.device)).cpu().numpy()
    run.pool = [np.ascontiguousarray(pool[i * b:(i + 1) * b]) for i in range(n)]
    run.order = np.random.default_rng(s_order).permutation(n)
    for i in range(2):  # the first call of each method captures, the second replays
        z = run.api.encode_images(run.pool[run.order[i % n]])
        images = run.api.sample_at(z)
    run.sample = Reservoir(tr["check_batches"], s_sample)
    # the sampled answers are copied into buffers of the benchmark's own, so
    # that the window drops every array the program returns, as a caller that
    # uses each batch and lets it go does
    run.kept = [(np.empty_like(z), np.empty_like(images)) for _ in range(tr["check_batches"])]


def window(run, seconds):
    api, pool, order, sample = run.api, run.pool, run.order, run.sample
    start = time.perf_counter()
    end, i = start + seconds, 0
    while True:
        k = int(order[i % len(order)])
        with run.span("encode_images"):
            z = api.encode_images(pool[k])
        with run.span("sample_at"):
            images = api.sample_at(z)
        j = sample.draw()
        if j is not None:
            kept_z, kept_images = run.kept[j]
            np.copyto(kept_z, z)
            np.copyto(kept_images, images)
            sample.put(j, (k, kept_z, kept_images))
        del z, images
        i += 1
        if time.perf_counter() >= end:
            break
    run.window_s = time.perf_counter() - start
    run.work = i


def release(run):
    del run.api


def end_to_end(run):
    return {"encdec_imgs_per_s": run.work * run.traffic["batch"] / run.window_s}


def readings(run, subject):
    """Z of each sampled batch against the reference's encode of its faces,
    and its images against the reference's decode of that Z (the latents
    the caller handed to `sample_at`); subject "control": the reference in
    TF32 in the program's place."""
    ref = Model(run.config, "float32")
    sub = Model(run.config, "tf32") if subject == "control" else None
    z_gaps, im_gaps = [], []
    with torch.no_grad():
        for k, z, images in run.sample.items:
            x = torch.from_numpy(run.pool[k]).to(run.device)
            z = torch.from_numpy(z).to(run.device)
            z_gaps.append(rel_gap(sub.encode(run.variables, x) if sub else z, ref.encode(run.variables, x)))
            want = ref.decode(run.variables, z)
            im_gaps.append(abs_gap(sub.decode(run.variables, z) if sub else images, want))
    return {"encode_z": max(z_gaps), "decode_image": max(im_gaps)}


def unit_flops(run):
    """Operations of one batch: the reference's encode and decode."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = run.config
    v = {k: torch.empty(t.shape, device="meta") for k, t in run.variables.items()}
    x = torch.empty((run.traffic["batch"], *cfg["image"]), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model = Model(cfg)
        model.decode(v, model.encode(v, x))
    return counter.get_total_flops()
