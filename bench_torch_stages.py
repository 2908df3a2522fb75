"""Per-stage profile of full-IAN encode + decode on one NVIDIA GPU (the port's
counterpart of bench_stages.py).

Each stage of the reference's profile is timed on its own: encode (total),
decode (total), fc2 + unflatten, the three deconvs, the three MDBLOCKs,
deconv4 + BN, and the RGB-Beta head. For each it prints ms a batch, imgs/s,
the reference's analytic multiply-add count (`bench_stages.py:52 conv_macs`
and its sums; a stage the reference does not count, decode (total), has none)
and the TFLOP/s that count gives, then one JSON line of the rows.

A stage's ms is device time by CUDA-graph replay (`utils/timing.graph_ms`:
`--iters` calls captured in one graph, replayed `--rounds` times), the
counterpart of the reference's jitted, chained program; `eager_ms` beside it
is the same call back to back on the host (`cuda_ms`), host launch gaps
included. It runs in bf16 by default, as the reference does (`--dtype
float32` for the other, TF32 off as in the other bench scripts);
`--mdblock-mode plain|fused` and `--head-mode` pick the port's forms where
the reference's `--mdcl-mode` picked an XLA formulation the port does not
have. Inputs and weights are seeded random draws at full width; the stage
inputs are the reference's (N(0, 0.1^2) maps at each stage's shape, NCHW
here). Widths are read from the weights, so the tiny profile runs the same
code (the tests do, on the CPU).

Usage: python3 bench_torch_stages.py [--batch 128] [--dtype bfloat16|float32]
           [--mdblock-mode plain|fused] [--head-mode hybrid|fused|plain] [--iters 10] [--rounds 5]
Prints one JSON line. Exits nonzero without a CUDA device.
"""

import argparse
import json
import subprocess
import sys

import torch

DTYPES = ("bfloat16", "float32")
MDBLOCK_MODES = ("plain", "fused")  # models/common.py MDBLOCK_MODES
HEAD_MODES = ("hybrid", "fused", "plain")  # models/common.py HEAD_MODES, the default first


def conv_macs(spatial, taps, cin, cout):
    """bench_stages.py:52: multiply-adds of a conv at a square output."""
    return spatial * spatial * taps * cin * cout


def widths(v):
    """Full IAN's widths, read from its weights: the encoder's four convs and
    its FC, and the decoder's 4x4 map and four deconvs' outputs."""
    enc = tuple(v[f"enc_conv{i}.W"].shape[0] for i in range(1, 5))
    dec = (v["l_dec_fc2.W"].shape[1] // 16,) + tuple(v[f"dec_conv{i}.W"].shape[1] for i in range(1, 5))
    return enc, v["enc_fc1.W"].shape[1], dec


def stage_macs(enc, fc, dec, zdim):
    """The reference's analytic multiply-adds a image of each stage
    (bench_stages.py:94-147), for these widths; None where it counts none.
    The MDBLOCKs count the composed 5x5 / 7x7 kernels as the reference does
    (the kernel's nonzero taps are 18 and 27 of them); the deconvs a quarter
    of a dense conv's."""
    d0, d1, d2, d3, d4 = dec
    return {
        "encode(total)": conv_macs(32, 75, 1, enc[0]) + conv_macs(16, 25, enc[0], enc[1])
        + conv_macs(8, 25, enc[1], enc[2]) + conv_macs(4, 25, enc[2], enc[3]) + 16 * enc[3] * fc + 2 * fc * zdim,
        "decode(total)": None,
        "fc2+unflatten": zdim * 16 * d0,
        f"deconv1 {d0}->{d1} @8": conv_macs(8, 25, d0, d1) // 4,
        f"mdblock2a @8 {d1} [0,2]": 2 * conv_macs(8, 25, d1, d1),
        f"deconv2 {d1}->{d2} @16": conv_macs(16, 25, d1, d2) // 4,
        f"mdblock3a @16 {d2} [0,2,3]": 2 * conv_macs(16, 49, d2, d2),
        f"deconv3 {d2}->{d3} @32": conv_macs(32, 25, d2, d3) // 4,
        f"mdblock4a @32 {d3} [0,2,3]": 2 * conv_macs(32, 49, d3, d3),
        f"deconv4+bn {d3}->{d4} @64": conv_macs(64, 25, d3, d4) // 4,
        "rgb_beta_head @64": conv_macs(64, 81, d4, 6) + conv_macs(64, 81, 2, 2) + conv_macs(64, 81, 4, 2),
    }


def stages(module, v, batch, dtype, device, mdblock_mode, head_mode, seed=1):
    """[(name, fn, MACs a image or None)]: each stage of full-IAN encode +
    decode as a call of the port's own functions on seeded inputs of its
    shape, in the names and order of the reference's profile."""
    from npe_tpu_torch.models import common
    from npe_tpu_torch.ops.conv import deconv2d
    from npe_tpu_torch.ops.linear import dense

    enc, fc, dec = widths(v)
    zdim = v["l_dec_fc2.W"].shape[0]
    macs = stage_macs(enc, fc, dec, zdim)
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=0.1):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    x_img, z = draw(batch, 3, 64, 64, scale=0.5), draw(batch, zdim, scale=1.0)
    h4, h8, h16, h32, h64 = (draw(batch, c, s, s) for c, s in zip(dec, (4, 8, 16, 32, 64)))
    lrelu = common.LRELU

    def block(name, h, scales):
        return lambda: common.mdblock(v, None, name, h, scales, lrelu, False, mode=mdblock_mode)

    fns = [
        lambda: module.encode(v, x_img),
        lambda: module.decode(v, z, mdblock_mode=mdblock_mode, head_mode=head_mode),
        lambda: common.unflatten_nchw(lrelu(dense(z, v["l_dec_fc2.W"], v["l_dec_fc2.b"])), dec[0], 4, 4),
        lambda: deconv2d(h4, v["dec_conv1.W"], v["dec_conv1.b"]),
        block("dec_conv2a", h8, (0, 2)),
        lambda: deconv2d(h8, v["dec_conv2.W"], v["dec_conv2.b"]),
        block("dec_conv3a", h16, (0, 2, 3)),
        lambda: deconv2d(h16, v["dec_conv3.W"], v["dec_conv3.b"]),
        block("dec_conv4a", h32, (0, 2, 3)),
        lambda: lrelu(common.bn(v, None, "bnorm_dc4", deconv2d(h32, v["dec_conv4.W"]), False)),
        lambda: module.rgb_beta_head(v, h64, mode=head_mode),
    ]
    return [(name, fn, macs[name]) for name, fn in zip(macs, fns)]


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    p.add_argument("--mdblock-mode", default="plain", choices=MDBLOCK_MODES)
    p.add_argument("--head-mode", default="hybrid", choices=HEAD_MODES)
    p.add_argument("--iters", type=int, default=10, help="calls captured in one CUDA graph")
    p.add_argument("--rounds", type=int, default=5, help="replays of the graph timed")
    a = p.parse_args(argv)
    if a.batch < 1 or a.iters < 1 or a.rounds < 1:
        p.error("--batch, --iters and --rounds must be positive")
    return a


def main(argv=None):
    a = parse(argv)
    if not torch.cuda.is_available():
        print("bench_torch_stages: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.utils.cast import cast_floating
    from npe_tpu_torch.utils.timing import cuda_ms, graph_ms

    dtype = getattr(torch, a.dtype)
    module = get_config("IAN")
    v = cast_floating(module.init(torch.Generator().manual_seed(0), "cuda"), dtype)
    smi = nvidia_smi()
    print(f"model=IAN batch={a.batch} dtype={a.dtype} mdblock_mode={a.mdblock_mode} head_mode={a.head_mode} "
          f"({smi})", file=sys.stderr)
    rows = []
    with torch.no_grad():
        for name, fn, macs in stages(module, v, a.batch, dtype, "cuda", a.mdblock_mode, a.head_mode):
            out = fn()
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all()), f"{name} gave a value that is not finite"
            ms = graph_ms(fn, iters=a.iters, reps=a.rounds)
            eager = cuda_ms(fn, a.iters)
            tflops = 2 * macs * a.batch / ms / 1e9 if macs else None
            rows.append({"stage": name, "ms_per_batch": ms, "eager_ms_per_batch": eager,
                         "imgs_per_sec": a.batch / ms * 1e3, "macs_per_img": macs, "tflops": tflops})
            print(f"{name:28s} {ms:8.3f} ms/batch ({eager:8.3f} eager) {a.batch / ms * 1e3:10.0f} imgs/s"
                  + (f"  {tflops:6.2f} TFLOP/s" if tflops else ""), file=sys.stderr)
    print(json.dumps({"metric": "stage_profile", "model": "IAN", "batch": a.batch, "dtype": a.dtype,
                      "mdblock_mode": a.mdblock_mode, "head_mode": a.head_mode, "iters": a.iters,
                      "rounds": a.rounds, "rows": rows, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
