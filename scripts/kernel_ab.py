"""Another build of a hand kernel against the current one, on one NVIDIA GPU
(Hopper), from the root of the repository:

    git archive 9a0f129 npe_tpu_torch/csrc | tar -x -C scratch_archive/base
    python3 scripts/kernel_ab.py scratch_archive/base   # 9a0f129's edit_tail and RGB-Beta head
    git archive 76a5cfd npe_tpu_torch/csrc | tar -x -C scratch_archive/pr10
    python3 scripts/kernel_ab.py --mdblock-bf16 scratch_archive/pr10   # 76a5cfd's bf16 MDBLOCK
    git archive 1f72098 npe_tpu_torch/csrc | tar -x -C scratch_archive/pr17
    python3 scripts/kernel_ab.py --mdblock-bwd scratch_archive/pr17    # 1f72098's MDBLOCK backwards
    git archive 6dbdcdd npe_tpu_torch/csrc | tar -x -C scratch_archive/pr22
    python3 scripts/kernel_ab.py --mdblock-fwd scratch_archive/pr22    # 6dbdcdd's float32 MDBLOCK forward

The earlier side is bound to commit 9a0f129 (edit_tail one block per image;
the head's trunk as nine tap products over the space-to-depth(4) map, cut
into slices added by a second launch): its C entry points are
`npe_edit_tail` without the band rows and `npe_rgb_beta_head` over s2d tap
matrices (9, 16C, 96) with a scratch of partial sums, and its slice rule is
`trunk_splits` below. Another commit's sources need those changed. The
other side is built with the package's nvcc flags into
`npe_tpu_torch/_build/baseline/`; the current kernels go through their
wrappers. Each side runs in a process of its own (two builds of one kernel
source loaded into one process are not to be trusted), in turns: other,
current, current, other. Cases: edit_tail at batch 1 and 8 (sigma 0.7), the
head at C 64 batch 1, 2 and 128 and at C 128 batch 1 (both sides over the
same weights: the earlier side's s2d taps are packed from the current side's
stacked taps). A side first holds its kernel against the plain version
(chip_smoke.py's KERNEL_TOL, HEAD_TOL, MDBLOCK_TOL) and fails if it
disagrees, then times it by CUDA-graph replay. `--mdblock-bf16` sets
76a5cfd's bf16 MDBLOCK (`npe_mdblock_bf16` in its mdblock.cu, 6dbdcdd's
`npe_mdblock` ABI and `parent_splits` rule, one mma.sync product a 16-channel
step) against the current one (`csrc/mdblock_bf16.cu` through the wrapper)
at full IAN's three shapes at batch 1 and 128, each held to the bf16 plain
version within chip_smoke.py's bf16 rule (BF16_POINTS steps of |want| +
std; its error is the worst fraction of that rule). Beside them, in every
process, the hybrid head's trunk (one cuDNN conv over the s2d map) at the
head's shapes, a yardstick for the kernel's trunk and a control of drift
between processes; on the current side the trunk alone (its launch and the
pass that adds the slices) and an empty kernel of edit_tail's grid (the
launch floor, scripts/launch_floor.py). The yardstick, the trunk alone and
the empty kernel are timed, not checked (their error is null). One line
per case, and a JSON summary in runs/kernel_ab.json or
runs/kernel_ab_mdblock_bf16.json (git-ignored).

`--mdblock-bwd` sets 1f72098's MDBLOCK backwards (`npe_mdblock_bwd` in its
mdblock.cu: 3xTF32 mma.sync, slices by `parent_splits`; `npe_mdblock_bwd_bf16`
in its mdblock_bf16.cu: wgmma with each tap tile read once a part, on
`bf16_plan`) against the current ones (`csrc/mdblock_bwd.cu` through the
wrapper's `_launch_bwd`, on `bwd_plan`), at full IAN's three shapes at batch
1, 8 and 128 in float32 and bf16, and the two forwards (`npe_mdblock`,
`npe_mdblock_bf16`: the same code on both sides, so a control of drift) at
batch 1 and 128. Each side runs its own forward for the y and h1 its
backward reads, holds the forward to `mdblock_taps_reference` (MDBLOCK_TOL;
bf16 the bf16 rule) and the backward to `mdblock_backward_reference` (float32
within MDBLOCK_BWD_TOL of the largest value; bf16 within BF16_POINTS + 1
steps; its error is the worst fraction of that limit), then times both. In
every process the per-op block's backward (cuDNN convolutions over the same
taps, forward and backward less forward) is timed beside them as a second
control. Summary in runs/kernel_ab_mdblock_bwd.json.

`--mdblock-fwd` sets 6dbdcdd's float32 MDBLOCK forward (`npe_mdblock` in its
mdblock.cu: 3xTF32 mma.sync over NCHW planes staged through registers, its
slices by `parent_splits`) against the current one (`csrc/mdblock.cu`
through `mdblock_fused` under no_grad, on `fwd_plan`: the path of the
inference callers, which writes no h1 for a backward) at full IAN's three
shapes at batch 1, 8 and 128. Each side holds its forward to
`mdblock_taps_reference` within MDBLOCK_TOL, then times it; the per-op
block's forward (cuDNN convolutions over the same taps) is timed beside it
in every process as a control. Summary in runs/kernel_ab_mdblock_fwd.json.
"""

import ctypes
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, ".")
from chip_smoke import (BF16_POINTS, BF16_STEP, HEAD_TOL, KERNEL_TOL, MDBLOCK_BWD_TOL,  # noqa: E402
                        MDBLOCK_TOL, mdblock_inputs)
from npe_tpu_torch.ops.conv import conv2d, space_to_depth  # noqa: E402
from npe_tpu_torch.ops.kernels import build  # noqa: E402
from npe_tpu_torch.ops.kernels import edit_tail as et  # noqa: E402
from npe_tpu_torch.ops.kernels import mdblock as mk  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_head as rh  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt  # noqa: E402
from npe_tpu_torch.utils.timing import graph_ms  # noqa: E402

import launch_floor  # noqa: E402  (scripts/launch_floor.py, beside this file)

MDBLOCK_SHAPES = ((512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3)))
EDIT_BATCHES = (1, 8)
HEAD_CASES = ((64, 1), (64, 2), (64, 128), (128, 1))  # (channels, batch)
HEAD_SCALES = (2, 3, 4)
BASELINE_DIR = os.path.join(build.BUILD_DIR, "baseline")


def nvcc(src, lib):
    """nvcc of `src` into _build/baseline/`lib`; nvcc's report lines."""
    os.makedirs(BASELINE_DIR, exist_ok=True)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", os.path.join(BASELINE_DIR, lib), src],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}")
    return [line.strip() for line in r.stdout.splitlines() if "Used" in line or "spill" in line]


def library_entry(lib, name, abi=None):
    """An entry point of _build/baseline/`lib`: `npe_mdblock` (6dbdcdd's ABI),
    76a5cfd's `npe_mdblock_bf16` (the same ABI), 9a0f129's `npe_edit_tail`
    and `npe_rgb_beta_head`, or 1f72098's `npe_mdblock_bwd`,
    `npe_mdblock_bwd_bf16` and (`abi` "npe_mdblock_bf16_plan")
    `npe_mdblock_bf16` on `bf16_plan`."""
    fn = getattr(ctypes.CDLL(os.path.join(BASELINE_DIR, lib)), name)
    fn.argtypes = {
        "npe_mdblock": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
        "npe_mdblock_bf16": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                                                           ctypes.c_void_p],
        "npe_edit_tail": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        "npe_rgb_beta_head": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        # 1f72098's: the shape, the dilations, then its splits (float32) or bf16_plan
        "npe_mdblock_bwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                                                            ctypes.c_void_p],
        "npe_mdblock_bwd_bf16": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 4
                                + [ctypes.c_void_p],
        "npe_mdblock_bf16_plan": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p],
    }[abi or name]
    fn.restype = ctypes.c_int
    return fn


def parent_splits(batch, tiles, units, sm_count, blocks_per_sm=2):
    """The slice count of 6dbdcdd's float32 MDBLOCK (its `inner_splits`):
    the largest divisor of `units` (taps x steps of 16 input channels) that
    leaves all blocks (batch x 64 x 128 tiles x slices) in one wave of two a
    multiprocessor. 1f72098's and 76a5cfd's kernels took the same rule."""
    most = max(1, blocks_per_sm * sm_count // (batch * tiles))
    return max(d for d in range(1, min(most, units) + 1) if units % d == 0)


def trunk_splits(batch, tiles, units, sm_count, most=36):
    """9a0f129's slice count for its trunk: the smallest divisor of `units`
    (9 taps x C/2 channel pairs) that gives two blocks per SM, at most 36."""
    want = -(-2 * sm_count // (batch * tiles))
    divisors = [d for d in range(1, most + 1) if units % d == 0]
    return next((d for d in divisors if d >= want), divisors[-1])


def s2d_trunk_taps(taps, scales):
    """The stacked trunk taps (T, C, 6) as 9a0f129's head wants them: the
    composed 9x9 kernel packed to (9, 16C, 96) s2d tap matrices."""
    k = taps.new_zeros((6, taps.shape[1], 9, 9))
    for t, (dy, dx) in enumerate(mk.tap_offsets(scales)):
        k[:, :, 4 + dy, 4 + dx] += taps[t].t()
    return rt.pack_head_taps(k, 4)


def bf16_rule(got, want, points=BF16_POINTS):
    """The worst |got - want| over chip_smoke.py's bf16 limit, `points`
    steps of 2^-8 of |want| + std(want) (1 is the limit)."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (points * BF16_STEP * (w.abs() + w.std()))).max())


def perop_block(x, taps1, taps2, aff, scales):
    """The MDBLOCK as per-op library calls over the same taps: each MDCL one
    cuDNN convolution per branch (the branch's nine taps as a dilated 3x3
    filter), the affines and lrelus elementwise; in x's dtype."""
    def mdcl(h, taps):
        out = 0
        for b, d in enumerate(mk.dilations(scales)):
            w = taps[9 * b:9 * b + 9].permute(2, 1, 0).reshape(taps.shape[2], taps.shape[1], 3, 3)
            out = out + torch.nn.functional.conv2d(h, w, padding=d, dilation=d)
        return out

    s0, t0, s1, t1, s2, t2 = (a[None, :, None, None].to(x.dtype) for a in aff)
    lrelu = lambda v: torch.nn.functional.leaky_relu(v, 0.2)  # noqa: E731
    return lrelu(s2 * (x + mdcl(lrelu(s1 * mdcl(lrelu(s0 * x + t0), taps1) + t1), taps2)) + t2)


def mdblock_bwd_side(side, measure, stream, sms, dev):
    """One side of `--mdblock-bwd`: its forward and backward at full IAN's
    shapes, checked, then timed; the per-op block's backward beside them."""
    if side != "current":
        fwd32, fwd16 = library_entry("libmdblock.so", "npe_mdblock"), library_entry("libmdblock_bf16.so", "npe_mdblock_bf16",
                                                                                   "npe_mdblock_bf16_plan")
        bwd32, bwd16 = library_entry("libmdblock.so", "npe_mdblock_bwd"), library_entry("libmdblock_bf16.so",
                                                                                      "npe_mdblock_bwd_bf16")
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for c, size, scales in MDBLOCK_SHAPES:
            br = mk.dilations(scales)
            dil = (ctypes.c_int * len(br))(*br)
            for batch in (1, 8, 128):
                x, t1, t2, aff = mdblock_inputs(batch, c, size, scales, 200 + batch, dev)
                x, t1, t2 = (t.to(dtype) for t in (x, t1, t2))
                g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(batch), device=dev).to(dtype)
                if side == "current":
                    def forward():
                        out, h1, rc = (mk._launch_bf16 if bf16 else mk._launch_float32)(x, t1, t2, aff, scales)  # noqa: B023
                        assert rc == 0, rc
                        return out, h1

                    def backward(y, h1):
                        dx, rc = mk._launch_bwd(g, x, y, h1, t1, t2, aff, scales)  # noqa: B023
                        assert rc == 0, rc
                        return dx
                else:
                    n, h, w = batch, size, size
                    out = torch.empty_like(x)
                    if bf16:  # 1f72098's plan: bf16_plan, one for both directions
                        plan = mk.bf16_plan(n, c, h, w, scales, sms)
                        act, h1_ = torch.empty_like(x), torch.empty((n, h, w, c), dtype=dtype, device=dev)
                        gr, gm1 = (torch.empty((2, n, h, w, c), dtype=dtype, device=dev) for _ in range(2))
                        splits, rest = plan.splits, (plan.sub_tiles, int(plan.halo), plan.tile_channels, plan.splits)
                    else:
                        tiles = (h * w // mk.TILE_PIXELS) * -(-c // mk.TILE_CHANNELS)
                        splits = parent_splits(n, tiles, 9 * len(br) * c // 16, sms)
                        h1_, gr, gm1 = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
                        rest = (splits,)
                    partial = torch.empty((n, splits, c, h, w), dtype=torch.float32, device=dev) if splits > 1 else None
                    pp = None if partial is None else partial.data_ptr()
                    dx_ = torch.empty_like(x)

                    def forward():
                        args = (x.data_ptr(), t1.data_ptr(), t2.data_ptr(), aff.data_ptr(),  # noqa: B023
                                *((act.data_ptr(),) if bf16 else ()), h1_.data_ptr(), pp, out.data_ptr(),  # noqa: B023
                                n, c, h, w, len(br), dil, *rest, stream())  # noqa: B023
                        rc = (fwd16 if bf16 else fwd32)(*args)  # noqa: B023
                        assert rc == 0, rc
                        return out, h1_  # noqa: B023

                    def backward(y, h1):
                        rc = (bwd16 if bf16 else bwd32)(g.data_ptr(), x.data_ptr(), y.data_ptr(), h1.data_ptr(),  # noqa: B023
                                                        t1.data_ptr(), t2.data_ptr(), aff.data_ptr(), gr.data_ptr(),  # noqa: B023
                                                        gm1.data_ptr(), pp, dx_.data_ptr(), n, c, h, w, len(br),  # noqa: B023
                                                        dil, *rest, stream())  # noqa: B023
                        assert rc == 0, rc
                        return dx_  # noqa: B023

                key = f"{'bf16' if bf16 else 'float32'} {size}x{size}x{c} batch {batch}"
                reps = 5 if batch == 128 else 20
                with torch.no_grad():
                    y, h1 = (t.clone() for t in forward())
                    if batch != 8:
                        measure(f"mdblock forward {key}", forward,
                                lambda: (mk.mdblock_taps_reference(x, t1, t2, aff, scales), None),  # noqa: B023
                                1.0 if bf16 else MDBLOCK_TOL, reps,
                                error=lambda got, want: bf16_rule(got[0], want[0]) if bf16  # noqa: B023
                                else float((got[0] - want[0]).abs().max()))
                    h1_nchw = h1.permute(0, 3, 1, 2) if bf16 else h1
                    ref = mk.mdblock_backward_reference(g, x, y, h1_nchw, t1, t2, aff, scales)

                    def bwd_error(got, want):
                        if bf16:
                            return bf16_rule(got, want, BF16_POINTS + 1)
                        return float((got - want).abs().max()) / (MDBLOCK_BWD_TOL * float(want.abs().max()))

                    measure(f"mdblock backward {key}", lambda: backward(y, h1), lambda: ref,  # noqa: B023
                            1.0, reps, error=bwd_error)

                def perop_fb():
                    leaf = x.detach().requires_grad_(True)  # noqa: B023
                    return torch.autograd.grad(perop_block(leaf, t1, t2, aff, scales), leaf, g)  # noqa: B023

                measure(f"per-op block forward and backward {key}", perop_fb, reps=reps)
                with torch.no_grad():
                    measure(f"per-op block forward {key}", lambda: perop_block(x, t1, t2, aff, scales),  # noqa: B023
                            reps=reps)


def mdblock_fwd_side(side, measure, stream, sms, dev):
    """One side of `--mdblock-fwd`: its float32 forward at full IAN's shapes,
    checked, then timed; the per-op block's forward beside it."""
    old = None if side == "current" else library_entry("libmdblock.so", "npe_mdblock")
    for c, size, scales in MDBLOCK_SHAPES:
        br = mk.dilations(scales)
        for batch in (1, 8, 128):
            x, t1, t2, aff = mdblock_inputs(batch, c, size, scales, 200 + batch, dev)
            if old is None:
                fn = lambda: mk.mdblock_fused(x, t1, t2, aff, scales)  # noqa: E731, B023
            else:
                tiles = (size * size // 64) * -(-c // 128)
                splits = parent_splits(batch, tiles, 9 * len(br) * c // 16, sms)
                h1, out = torch.empty_like(x), torch.empty_like(x)
                partial = x.new_empty((batch, splits, c, size, size)) if splits > 1 else None

                def fn():
                    rc = old(x.data_ptr(), t1.data_ptr(), t2.data_ptr(), aff.data_ptr(), h1.data_ptr(),  # noqa: B023
                             None if partial is None else partial.data_ptr(), out.data_ptr(), batch, c, size,  # noqa: B023
                             size, len(br), (ctypes.c_int * len(br))(*br), splits, stream())  # noqa: B023
                    assert rc == 0, rc
                    return out  # noqa: B023

            key = f"{size}x{size}x{c} batch {batch}"
            reps = 5 if batch == 128 else 20
            measure(f"mdblock forward {key}", fn,
                    lambda: mk.mdblock_taps_reference(x, t1, t2, aff, scales), MDBLOCK_TOL, reps)  # noqa: B023
            measure(f"per-op block forward {key}", lambda: perop_block(x, t1, t2, aff, scales), reps=reps)  # noqa: B023


def run_side(side, what):
    """Checks and times one side's kernels; {case: {"ms", "err"}}."""
    # a launch outside the capturing stream leaves the timed graph empty
    warnings.filterwarnings("error", message="The CUDA Graph is empty")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}

    def measure(case, fn, plain=None, tol=None, reps=100, error=lambda got, want: float((got - want).abs().max())):
        """Times fn; first holds it to `plain` within `tol`, where it has one
        (err None where nothing is checked: the yardstick, the empty kernel)."""
        err = None
        if plain is not None:
            err = error(fn(), plain())
            if not err <= tol:
                raise AssertionError(f"{side} {case} disagrees with its plain version: {err} > {tol}")
        torch.cuda.synchronize()
        results[case] = {"ms": graph_ms(fn, iters=reps, reps=10), "err": err}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if what == "mdblock_bwd":
        mdblock_bwd_side(side, measure, stream, sms, dev)
        return results
    with torch.no_grad():
        if what == "mdblock_fwd":
            mdblock_fwd_side(side, measure, stream, sms, dev)
            return results
        if what == "mdblock_bf16":
            md = None if side == "current" else library_entry("libmdblock.so", "npe_mdblock_bf16")
            bf = torch.bfloat16
            for c, size, scales in MDBLOCK_SHAPES:
                for batch in (1, 128):
                    rng = np.random.RandomState(c + batch)
                    n_taps = 9 * len(mk.dilations(scales))
                    x = torch.from_numpy(rng.randn(batch, c, size, size).astype(np.float32)).to(dev, bf)
                    t1, t2 = (torch.from_numpy((rng.randn(n_taps, c, c) / np.sqrt(2.2 * c)).astype(np.float32))
                              .to(dev, bf) for _ in range(2))
                    aff = torch.from_numpy(np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3)
                                           .astype(np.float32)).to(dev)
                    if md is None:
                        fn = lambda: mk.mdblock_fused(x, t1, t2, aff, scales)  # noqa: E731, B023
                    else:
                        br = mk.dilations(scales)
                        # 76a5cfd's rule for either dtype: 64 x 128 tiles, 16-channel steps
                        tiles = (size * size // mk.TILE_PIXELS) * -(-c // mk.TILE_CHANNELS)
                        splits = parent_splits(batch, tiles, n_taps * c // 16, sms)
                        h1, out = torch.empty_like(x), torch.empty_like(x)
                        partial = (torch.empty((batch, splits, c, size, size), dtype=torch.float32, device=dev)
                                   if splits > 1 else None)

                        def fn():
                            rc = md(x.data_ptr(), t1.data_ptr(), t2.data_ptr(), aff.data_ptr(), h1.data_ptr(),  # noqa: B023
                                    None if partial is None else partial.data_ptr(), out.data_ptr(), batch, c,  # noqa: B023
                                    size, size, len(br), (ctypes.c_int * len(br))(*br), splits, stream())  # noqa: B023
                            assert rc == 0, rc
                            return out  # noqa: B023

                    measure(f"mdblock_bf16 {size}x{size}x{c} batch {batch}", fn,
                            lambda: mk.mdblock_taps_reference(x, t1, t2, aff, scales),  # noqa: B023
                            1.0, 5 if batch == 128 else 20, error=bf16_rule)
            return results
        old_edit = old_head = None
        if side == "earlier":
            old_edit = library_entry("libedit_tail.so", "npe_edit_tail")
            old_head = library_entry("librgb_beta_head.so", "npe_rgb_beta_head")
        k, radius = et.gaussian_kernel_1d(0.7)
        taps = torch.from_numpy(k).to(dev)
        bm = et.blur_matrix(64, 0.7, device=dev)
        for batch in EDIT_BATCHES:
            rng = np.random.RandomState(batch)
            xh, recon = (torch.from_numpy(rng.rand(batch, 64, 64, 3).astype(np.float32) * 2 - 1).to(dev)
                         for _ in range(2))
            err = torch.from_numpy(rng.rand(batch, 64, 64, 3).astype(np.float32) * 0.2).to(dev)
            um = torch.from_numpy(rng.rand(batch, 64, 64).astype(np.float32) * 0.5).to(dev)
            if old_edit is None:
                fn = lambda: et.edit_tail(xh, recon, err, um, 0.7)  # noqa: E731, B023
                measure(f"edit_tail empty kernel batch {batch}",
                        lambda: launch_floor.edit_tail_floor(batch, 64, 0.7, dev))  # noqa: B023
            else:
                out = torch.empty_like(xh)

                def fn():
                    rc = old_edit(xh.data_ptr(), recon.data_ptr(), err.data_ptr(), um.data_ptr(), taps.data_ptr(),  # noqa: B023
                                  radius, out.data_ptr(), batch, 64, stream())  # noqa: B023
                    assert rc == 0, rc
                    return out  # noqa: B023

            measure(f"edit_tail batch {batch}", fn, lambda: et.edit_tail_reference(xh, recon, err, bm, um),  # noqa: B023
                    KERNEL_TOL, 100)
        for c, batch in HEAD_CASES:
            rng = np.random.RandomState(c + batch)
            x = torch.from_numpy(rng.randn(batch, c, 64, 64).astype(np.float32)).to(dev)
            tr = torch.from_numpy((rng.randn(36, c, 6) / np.sqrt(33 * c)).astype(np.float32)).to(dev)
            tg = torch.from_numpy((rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)).to(dev)
            tb = torch.from_numpy((rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)).to(dev)
            k_trunk = torch.from_numpy((rng.randn(96, 16 * c, 3, 3) / np.sqrt(9 * 16 * c)).astype(np.float32)).to(dev)
            reps = 5 if batch == 128 else 50
            if old_head is None:
                fn = lambda: rh.rgb_beta_head(x, tr, tg, tb, HEAD_SCALES)  # noqa: E731, B023
                measure(f"rgb_beta_head trunk (its launch and the slice sum) C {c} batch {batch}",
                        lambda: rh.trunk_only(x, tr, HEAD_SCALES), reps=reps)  # noqa: B023
            else:
                tr_s2d = s2d_trunk_taps(tr, HEAD_SCALES)
                splits = trunk_splits(batch, 4, 9 * c // 2, sms)
                trunk = torch.empty((batch, 96, 16, 16), device=dev)
                partial = trunk.new_empty((batch, splits, 96, 16, 16)) if splits > 1 else None
                out = torch.empty((batch, 3, 64, 64), device=dev)

                def fn():
                    rc = old_head(x.data_ptr(), tr_s2d.data_ptr(), tg.data_ptr(), tb.data_ptr(), trunk.data_ptr(),  # noqa: B023
                                  None if partial is None else partial.data_ptr(), out.data_ptr(), batch, c, 16,  # noqa: B023
                                  splits, rt.tail_rows(batch, 16, 16, sms), stream())  # noqa: B023
                    assert rc == 0, rc
                    return out  # noqa: B023

            measure(f"rgb_beta_head C {c} batch {batch}", fn,
                    lambda: rh.rgb_beta_head_reference(x, tr, tg, tb, HEAD_SCALES), HEAD_TOL, reps)  # noqa: B023
            measure(f"hybrid trunk, cuDNN conv, C {c} batch {batch}",
                    lambda: conv2d(space_to_depth(x, 4), k_trunk, padding=1), reps=reps)  # noqa: B023
    return results


def main():
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3, 4):
        print("kernel_ab: needs an NVIDIA GPU, and the earlier checkout's directory, --mdblock-bf16 "
              "and 76a5cfd's directory, --mdblock-bwd and 1f72098's, or --mdblock-fwd and 6dbdcdd's",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain versions in float32
    if sys.argv[1] == "--side":  # one side, in a process of its own: JSON on the last line
        print(json.dumps(run_side(sys.argv[2], sys.argv[3])))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    # {the current kernel's name: (the other side's source, its library)}
    if sys.argv[1] == "--mdblock-bwd":
        other, what = "parent", "mdblock_bwd"
        csrc = os.path.join(sys.argv[2], "npe_tpu_torch", "csrc")
        sources = {"mdblock": (os.path.join(csrc, "mdblock.cu"), "libmdblock.so"),
                   "mdblock_bf16": (os.path.join(csrc, "mdblock_bf16.cu"), "libmdblock_bf16.so")}
    elif sys.argv[1] == "--mdblock-fwd":
        other, what = "parent", "mdblock_fwd"
        sources = {"mdblock": (os.path.join(sys.argv[2], "npe_tpu_torch", "csrc", "mdblock.cu"), "libmdblock.so")}
    elif sys.argv[1] == "--mdblock-bf16":
        other, what = "earlier", "mdblock_bf16"
        sources = {"mdblock_bf16": (os.path.join(sys.argv[2], "npe_tpu_torch", "csrc", "mdblock.cu"), "libmdblock.so")}
    else:
        other, what = "earlier", "edit_head"
        sources = {name: (os.path.join(sys.argv[1], "npe_tpu_torch", "csrc", f"{name}.cu"), f"lib{name}.so")
                   for name in ("edit_tail", "rgb_beta_head")}
    for name, (src, lib) in sources.items():
        for line in nvcc(src, lib):
            print(f"[build] {other} {name}: {line}", flush=True)
    for name in [*sources, *(["mdblock_bwd"] if what == "mdblock_bwd" else [])]:
        for line in build.build(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] current {name}: {line.strip()}", flush=True)
    turns = (other, "current", "current", other)
    runs = []
    for side in turns:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", side, what],
                           stdout=subprocess.PIPE, text=True)
        if r.returncode != 0:
            print(f"kernel_ab: the {side} side failed ({r.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    results = []
    for case in runs[1]:
        t = [run.get(case, {}).get("ms") for run in runs]
        if t[0] is None:  # the current side's alone: the head's trunk, the empty kernel
            rec = {"case": case, "current_ms": [t[1], t[2]]}
            print(f"[ab] {case}: current {t[1]:.5f} / {t[2]:.5f} ms ({smi})", flush=True)
            results.append(rec)
            continue
        err = {other: runs[0][case]["err"], "current": runs[1][case]["err"]}
        rec = {"case": case, f"{other}_ms": [t[0], t[3]], "current_ms": [t[1], t[2]],
               "max_abs_err_vs_plain": err, "speedup": (t[0] + t[3]) / (t[1] + t[2])}
        measure = {"mdblock_bf16": "worst fraction of the bf16 rule",
                   "mdblock_bwd": "worst fraction of the rule"}.get(what, "max abs err vs plain")
        checked = (f"; {measure} {err[other]:.3e} / {err['current']:.3e}, each within its tolerance"
                   if err["current"] is not None else "; not checked (no plain version)")
        print(f"[ab] {case}: {other} {t[0]:.5f} / {t[3]:.5f} ms, current {t[1]:.5f} / {t[2]:.5f} ms "
              f"({rec['speedup']:.2f}x){checked} ({smi})", flush=True)
        results.append(rec)
    os.makedirs("runs", exist_ok=True)
    suffix = {"mdblock_bf16": "_mdblock_bf16", "mdblock_bwd": "_mdblock_bwd",
              "mdblock_fwd": "_mdblock_fwd"}.get(what, "")
    with open(f"runs/kernel_ab{suffix}.json", "w") as fh:
        json.dump({"device": smi, "turns": turns, "cases": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
