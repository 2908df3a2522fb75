"""Another build of the `mdblock_fused` (and `rgb_beta_tail`) kernel against
the current one, on one NVIDIA GPU (Hopper), from the root of the repository:

    git archive a8042ca npe_tpu_torch/csrc | tar -x -C scratch_archive/base
    python3 scripts/kernel_ab.py scratch_archive/base   # a8042ca's MDBLOCK and tail
    python3 scripts/kernel_ab.py --wgmma                # scripts/mdblock_wgmma.cu's MDBLOCK

The earlier side is bound to commit a8042ca (float32 FFMA MDBLOCK in 64 x 64
tiles, one tail block per image): its C entry points are `npe_mdblock` as
now and `npe_rgb_beta_tail` without the row count, and its slice rule is
the largest divisor that runs in one wave of four blocks a multiprocessor.
Another commit's sources need those changed. The wgmma side has the current
`npe_mdblock` entry point and its own slice rule (128-pixel tiles over the
batch, one block a multiprocessor). Both are built with the package's nvcc
flags into `npe_tpu_torch/_build/baseline/`; the current kernels go through
their wrappers. Each side runs in a process of its own (two builds of one
kernel source loaded into one process are not to be trusted), in turns:
other, current, current, other. At full IAN's three MDBLOCK shapes at batch
1, 8 and 128, and (against a8042ca) at the tail's batch 1, 8, 16 and 128, a
side first holds its kernel against the plain version (chip_smoke.py's
MDBLOCK_TOL and KERNEL_TOL) and fails if it disagrees, then times it by
CUDA-graph replay. One line per case, and a JSON summary in
runs/kernel_ab.json or runs/kernel_ab_wgmma.json (git-ignored).
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
from chip_smoke import KERNEL_TOL, MDBLOCK_TOL  # noqa: E402
from npe_tpu_torch.ops.kernels import build  # noqa: E402
from npe_tpu_torch.ops.kernels import mdblock as mk  # noqa: E402
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt  # noqa: E402
from npe_tpu_torch.utils.timing import graph_ms  # noqa: E402

MDBLOCK_SHAPES = ((512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3)))
TAIL_BATCHES = (1, 8, 16, 128)
BASELINE_DIR = os.path.join(build.BUILD_DIR, "baseline")
WGMMA_SOURCE = os.path.join("scripts", "mdblock_wgmma.cu")
# side: (its MDBLOCK library, pixels and channels of a tile, blocks a multiprocessor)
MDBLOCK_SIDES = {"earlier": ("libmdblock.so", 64, 64, 4), "wgmma": ("libmdblock_wgmma.so", 128, 128, 1)}


def nvcc(src, lib):
    """nvcc of `src` into _build/baseline/`lib`; nvcc's report lines."""
    os.makedirs(BASELINE_DIR, exist_ok=True)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", os.path.join(BASELINE_DIR, lib), src],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}")
    return [line.strip() for line in r.stdout.splitlines() if "Used" in line or "spill" in line]


def library_entry(lib, name):
    """`npe_mdblock`, or a8042ca's `npe_rgb_beta_tail`, from _build/baseline/`lib`."""
    fn = getattr(ctypes.CDLL(os.path.join(BASELINE_DIR, lib)), name)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   if name == "npe_mdblock" else [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def splits_of(side, batch, channels, hw, units, sms):
    """The side's slice count: the largest divisor of `units` that keeps all
    its blocks in one wave."""
    _, tile_p, tile_c, per_sm = MDBLOCK_SIDES[side]
    blocks = -(-batch * hw // tile_p) * -(-channels // tile_c)
    most = max(1, per_sm * sms // blocks)
    return max(d for d in range(1, min(most, units) + 1) if units % d == 0)


def run_side(side, with_tail):
    """Checks and times one side's kernels; {case: {"ms", "err"}}."""
    # a launch outside the capturing stream leaves the timed graph empty
    warnings.filterwarnings("error", message="The CUDA Graph is empty")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}

    def measure(case, fn, plain, tol, reps):
        err = float((fn() - plain()).abs().max())
        if not err <= tol:
            raise AssertionError(f"{side} {case} disagrees with its plain version: {err} > {tol}")
        torch.cuda.synchronize()
        results[case] = {"ms": graph_ms(fn, iters=reps, reps=10), "err": err}

    with torch.no_grad():
        md = None if side == "current" else library_entry(MDBLOCK_SIDES[side][0], "npe_mdblock")
        for c, size, scales in MDBLOCK_SHAPES:
            for batch in (1, 8, 128):
                rng = np.random.RandomState(c + batch)
                n_taps = 9 * len(mk.dilations(scales))
                x = torch.from_numpy(rng.randn(batch, c, size, size).astype(np.float32)).to(dev)
                t1, t2 = (torch.from_numpy((rng.randn(n_taps, c, c) / np.sqrt(2.2 * c)).astype(np.float32)).to(dev)
                          for _ in range(2))
                aff = torch.from_numpy(np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3)
                                       .astype(np.float32)).to(dev)
                if md is None:
                    fn = lambda: mk.mdblock_fused(x, t1, t2, aff, scales)  # noqa: E731, B023
                else:
                    br = mk.dilations(scales)
                    splits = splits_of(side, batch, c, size * size, n_taps * c // mk.CHANNEL_STEP, sms)
                    h1, out = torch.empty_like(x), torch.empty_like(x)
                    partial = x.new_empty((batch, splits, c, size, size)) if splits > 1 else None

                    def fn():
                        rc = md(x.data_ptr(), t1.data_ptr(), t2.data_ptr(), aff.data_ptr(), h1.data_ptr(),  # noqa: B023
                                None if partial is None else partial.data_ptr(), out.data_ptr(), batch, c,  # noqa: B023
                                size, size, len(br), (ctypes.c_int * len(br))(*br), splits,  # noqa: B023
                                torch.cuda.current_stream().cuda_stream)
                        assert rc == 0, rc
                        return out  # noqa: B023

                measure(f"mdblock {size}x{size}x{c} batch {batch}", fn,
                        lambda: mk.mdblock_taps_reference(x, t1, t2, aff, scales),  # noqa: B023
                        MDBLOCK_TOL, 5 if batch == 128 else 20)
        tail = library_entry("librgb_beta_tail.so", "npe_rgb_beta_tail") if with_tail and md is not None else None
        for batch in TAIL_BATCHES if with_tail else ():
            rng = np.random.RandomState(batch)
            trunk = torch.from_numpy(rng.randn(batch, 96, 16, 16).astype(np.float32)).to(dev)
            tg = torch.from_numpy((rng.randn(9, 32, 32) / np.sqrt(9 * 32 / 4)).astype(np.float32)).to(dev)
            tb = torch.from_numpy((rng.randn(9, 64, 32) / np.sqrt(9 * 64 / 4)).astype(np.float32)).to(dev)
            if tail is None:
                fn = lambda: rt.rgb_beta_tail(trunk, tg, tb)  # noqa: E731, B023
            else:
                out = torch.empty((batch, 48, 16, 16), device=dev)

                def fn():
                    rc = tail(trunk.data_ptr(), tg.data_ptr(), tb.data_ptr(), out.data_ptr(), batch, 16, 16,  # noqa: B023
                              torch.cuda.current_stream().cuda_stream)
                    assert rc == 0, rc
                    return out  # noqa: B023

            measure(f"rgb_beta_tail batch {batch}", fn,
                    lambda: rt.rgb_beta_tail_reference(trunk, tg, tb), KERNEL_TOL, 50)  # noqa: B023
    return results


def main():
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 4):
        print("kernel_ab: needs an NVIDIA GPU, and the earlier checkout's directory or --wgmma", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain versions in float32
    if sys.argv[1] == "--side":  # one side, in a process of its own: JSON on the last line
        print(json.dumps(run_side(sys.argv[2], sys.argv[3] == "tail")))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    other = "wgmma" if sys.argv[1] == "--wgmma" else "earlier"
    if other == "wgmma":
        sources = {"mdblock": WGMMA_SOURCE}
    else:
        sources = {name: os.path.join(sys.argv[1], "npe_tpu_torch", "csrc", f"{name}.cu")
                   for name in ("mdblock", "rgb_beta_tail")}
    for name, src in sources.items():
        for line in nvcc(src, MDBLOCK_SIDES[other][0] if name == "mdblock" else f"lib{name}.so"):
            print(f"[build] {other} {name}: {line}", flush=True)
        for line in build.build(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] current {name}: {line.strip()}", flush=True)
    turns = (other, "current", "current", other)
    runs = []
    for side in turns:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", side,
                            "tail" if "rgb_beta_tail" in sources else "mdblock"], stdout=subprocess.PIPE, text=True)
        if r.returncode != 0:
            print(f"kernel_ab: the {side} side failed ({r.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    results = []
    for case in runs[0]:
        t = [run[case]["ms"] for run in runs]
        err = {other: runs[0][case]["err"], "current": runs[1][case]["err"]}
        rec = {"case": case, f"{other}_ms": [t[0], t[3]], "current_ms": [t[1], t[2]],
               "max_abs_err_vs_plain": err, "speedup": (t[0] + t[3]) / (t[1] + t[2])}
        print(f"[ab] {case}: {other} {t[0]:.5f} / {t[3]:.5f} ms, current {t[1]:.5f} / {t[2]:.5f} ms "
              f"({rec['speedup']:.2f}x); max abs err vs plain {err[other]:.3e} / {err['current']:.3e}, "
              f"each within its tolerance ({smi})", flush=True)
        results.append(rec)
    os.makedirs("runs", exist_ok=True)
    with open(f"runs/kernel_ab{'_wgmma' if other == 'wgmma' else ''}.json", "w") as fh:
        json.dump({"device": smi, "turns": turns, "cases": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
