"""Another build of a hand kernel against the current one, on one NVIDIA GPU
(Hopper), from the root of the repository:

    git archive 9a0f129 npe_tpu_torch/csrc | tar -x -C scratch_archive/base
    python3 scripts/kernel_ab.py scratch_archive/base   # 9a0f129's edit_tail and RGB-Beta head
    python3 scripts/kernel_ab.py --wgmma                # scripts/mdblock_wgmma.cu's MDBLOCK

The earlier side is bound to commit 9a0f129 (edit_tail one block per image;
the head's trunk as nine tap products over the space-to-depth(4) map, cut
into slices added by a second launch): its C entry points are
`npe_edit_tail` without the band rows and `npe_rgb_beta_head` over s2d tap
matrices (9, 16C, 96) with a scratch of partial sums, and its slice rule is
`trunk_splits` below. Another commit's sources need those changed. The
wgmma side has the current `npe_mdblock` entry point and its own slice rule
(128-pixel tiles over the batch, one block a multiprocessor). Both are built
with the package's nvcc flags into `npe_tpu_torch/_build/baseline/`; the
current kernels go through their wrappers. Each side runs in a process of
its own (two builds of one kernel source loaded into one process are not to
be trusted), in turns: other, current, current, other. Cases: edit_tail at
batch 1 and 8 (sigma 0.7), the head at C 64 batch 1, 2 and 128 and at C 128
batch 1 (both sides over the same weights: the earlier side's s2d taps are
packed from the current side's stacked taps), or full IAN's three MDBLOCK
shapes at batch 1, 8 and 128. A side first holds its kernel against the
plain version (chip_smoke.py's KERNEL_TOL, HEAD_TOL, MDBLOCK_TOL) and fails
if it disagrees, then times it by CUDA-graph replay. Beside them, in every
process, the hybrid head's trunk (one cuDNN conv over the s2d map) at the
head's shapes, a yardstick for the kernel's trunk and a control of drift
between processes; on the current side the trunk alone (its launch and the
pass that adds the slices) and an empty kernel of edit_tail's grid (the
launch floor, scripts/launch_floor.py). The yardstick, the trunk alone and
the empty kernel are timed, not checked (their error is null). One line
per case, and a JSON summary in runs/kernel_ab.json or
runs/kernel_ab_wgmma.json (git-ignored).
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
from chip_smoke import HEAD_TOL, KERNEL_TOL, MDBLOCK_TOL  # noqa: E402
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
WGMMA_SOURCE = os.path.join("scripts", "mdblock_wgmma.cu")
WGMMA_LIB = "libmdblock_wgmma.so"


def nvcc(src, lib):
    """nvcc of `src` into _build/baseline/`lib`; nvcc's report lines."""
    os.makedirs(BASELINE_DIR, exist_ok=True)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", os.path.join(BASELINE_DIR, lib), src],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}")
    return [line.strip() for line in r.stdout.splitlines() if "Used" in line or "spill" in line]


def library_entry(lib, name):
    """An entry point of _build/baseline/`lib`: `npe_mdblock` (current ABI),
    or 9a0f129's `npe_edit_tail` and `npe_rgb_beta_head`."""
    fn = getattr(ctypes.CDLL(os.path.join(BASELINE_DIR, lib)), name)
    fn.argtypes = {
        "npe_mdblock": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
        "npe_edit_tail": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        "npe_rgb_beta_head": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


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


def run_side(side, what):
    """Checks and times one side's kernels; {case: {"ms", "err"}}."""
    # a launch outside the capturing stream leaves the timed graph empty
    warnings.filterwarnings("error", message="The CUDA Graph is empty")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}

    def measure(case, fn, plain=None, tol=None, reps=100):
        """Times fn; first holds it to `plain` within `tol`, where it has one
        (err None where nothing is checked: the yardstick, the empty kernel)."""
        err = None
        if plain is not None:
            err = float((fn() - plain()).abs().max())
            if not err <= tol:
                raise AssertionError(f"{side} {case} disagrees with its plain version: {err} > {tol}")
        torch.cuda.synchronize()
        results[case] = {"ms": graph_ms(fn, iters=reps, reps=10), "err": err}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    with torch.no_grad():
        if what == "mdblock":
            md = None if side == "current" else library_entry(WGMMA_LIB, "npe_mdblock")
            for c, size, scales in MDBLOCK_SHAPES:
                for batch in (1, 8, 128):
                    rng = np.random.RandomState(c + batch)
                    n_taps = 9 * len(mk.dilations(scales))
                    x = torch.from_numpy(rng.randn(batch, c, size, size).astype(np.float32)).to(dev)
                    t1, t2 = (torch.from_numpy((rng.randn(n_taps, c, c) / np.sqrt(2.2 * c)).astype(np.float32))
                              .to(dev) for _ in range(2))
                    aff = torch.from_numpy(np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3)
                                           .astype(np.float32)).to(dev)
                    if md is None:
                        fn = lambda: mk.mdblock_fused(x, t1, t2, aff, scales)  # noqa: E731, B023
                    else:
                        br = mk.dilations(scales)
                        # 128-pixel tiles over the batch, one block a multiprocessor: the largest
                        # divisor of the slices that keeps the blocks in one wave
                        units = n_taps * c // mk.CHANNEL_STEP
                        most = max(1, sms // (-(-batch * size * size // 128) * -(-c // 128)))
                        splits = max(d for d in range(1, min(most, units) + 1) if units % d == 0)
                        h1, out = torch.empty_like(x), torch.empty_like(x)
                        partial = x.new_empty((batch, splits, c, size, size)) if splits > 1 else None

                        def fn():
                            rc = md(x.data_ptr(), t1.data_ptr(), t2.data_ptr(), aff.data_ptr(), h1.data_ptr(),  # noqa: B023
                                    None if partial is None else partial.data_ptr(), out.data_ptr(), batch, c,  # noqa: B023
                                    size, size, len(br), (ctypes.c_int * len(br))(*br), splits, stream())  # noqa: B023
                            assert rc == 0, rc
                            return out  # noqa: B023

                    measure(f"mdblock {size}x{size}x{c} batch {batch}", fn,
                            lambda: mk.mdblock_taps_reference(x, t1, t2, aff, scales),  # noqa: B023
                            MDBLOCK_TOL, 5 if batch == 128 else 20)
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
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 4):
        print("kernel_ab: needs an NVIDIA GPU, and the earlier checkout's directory or --wgmma", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain versions in float32
    if sys.argv[1] == "--side":  # one side, in a process of its own: JSON on the last line
        print(json.dumps(run_side(sys.argv[2], sys.argv[3])))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if sys.argv[1] == "--wgmma":
        other, what, sources = "wgmma", "mdblock", {"mdblock": (WGMMA_SOURCE, WGMMA_LIB)}
    else:
        other, what = "earlier", "edit_head"
        sources = {name: (os.path.join(sys.argv[1], "npe_tpu_torch", "csrc", f"{name}.cu"), f"lib{name}.so")
                   for name in ("edit_tail", "rgb_beta_head")}
    for name, (src, lib) in sources.items():
        for line in nvcc(src, lib):
            print(f"[build] {other} {name}: {line}", flush=True)
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
        checked = (f"; max abs err vs plain {err[other]:.3e} / {err['current']:.3e}, each within its tolerance"
                   if err["current"] is not None else "; not checked (no plain version)")
        print(f"[ab] {case}: {other} {t[0]:.5f} / {t[3]:.5f} ms, current {t[1]:.5f} / {t[2]:.5f} ms "
              f"({rec['speedup']:.2f}x){checked} ({smi})", flush=True)
        results.append(rec)
    os.makedirs("runs", exist_ok=True)
    with open(f"runs/kernel_ab{'_wgmma' if other == 'wgmma' else ''}.json", "w") as fh:
        json.dump({"device": smi, "turns": turns, "cases": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
