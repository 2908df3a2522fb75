"""The MDBLOCK kernels' share of their roofline, %: the least time of the
forward and backward launches the window ran (the program's launch
counters, each launch one block of the configuration's decoder at the
cell's batch, `bounds.mdblock_bound_ms` on the 3xTF32 route) over the
union of the device intervals of those kernels (`bounds.KERNEL_GROUPS`)."""

from benchmark.yardstick.bounds import kernel_group, mdblock_bound_ms


def block_shapes(cfg):
    dec = cfg["decoder"]
    return [(c, 8 * 2 ** i, s) for i, (c, s) in enumerate(zip(dec["widths"], dec["mdblock_scales"]))]


def read(run):
    if run.profile is None or run.config["decoder"]["kind"] != "mdblock":
        return None
    fwd, bwd = run.counts.get("mdblock_fused.launches", 0), run.counts.get("mdblock_fused.launches_bwd", 0)
    seconds, n = run.profile.kernel_seconds(lambda name: kernel_group(name) in ("mdblock_fwd", "mdblock_bwd"))
    if not (fwd or bwd) or not n or seconds <= 0:
        return None
    shapes = block_shapes(run.config)
    per = [sum(mdblock_bound_ms(run.batch, c, hw, s, backward=b)[0] for c, hw, s in shapes) / len(shapes)
           for b in (False, True)]
    return 100.0 * (fwd * per[0] + bwd * per[1]) / 1e3 / seconds
