"""The least time each hand kernel of the port could take on one H100, from
its shapes and the card's published peaks, and the table that names each
kernel's device records.

A frozen copy of the bound functions of the repository's `chip_smoke.py`
(`roofline_ms`, `kernel_bound_ms`, `mdblock_bound_ms`, `tail_work`,
`rgb_beta_tail_bound_ms`, `rgb_beta_tail_bwd_bound_ms`, `edit_tail_bound_ms`,
`staging_bound_ms`) and of its `DEVICE_KERNELS` names. The benchmark keeps
its own copy so that a change to the program cannot move its yardstick.
Every bound is (ms, "bytes" or "operations"): the larger of the bytes over
HBM bandwidth and the operations over the peak that does them.
"""

import re

# One H100 SXM, NVIDIA's data sheet, dense rates, at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # TF32 on the tensor cores
BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores
PEAK_OPS_PER_S = {"float32": FP32_OPS_PER_S, "tf32": TF32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}


def roofline_ms(nbytes, flops, peak=FP32_OPS_PER_S):
    """The larger of the bytes over HBM bandwidth and the operations over
    `peak`, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_bound_ms(nbytes, products, other, dtype):
    """roofline_ms of a kernel's bytes, its multiply-adds' operations
    (`products`) and its elementwise float32 operations (`other`): in float32
    all of them at the float32 rate; in bfloat16 the products at the tensor
    cores' bf16 rate and the rest at the float32 rate, in bf16-rate units."""
    if dtype == "bfloat16":
        return roofline_ms(nbytes, products + other * BF16_OPS_PER_S / FP32_OPS_PER_S, BF16_OPS_PER_S)
    return roofline_ms(nbytes, products + other)


def mdblock_bound_ms(batch, channels, size, scales, route="3xtf32", backward=False):
    """Least time for one MDBLOCK: x and both tap tensors and the affines
    read once, the output written once; two MDCLs of H*W*T*C^2 multiply-adds,
    and about ten float32 operations per element for the three affines,
    lrelus and the residual. route "3xtf32", the float32 kernel's: each
    multiply-add is three TF32 products on the tensor cores (two operations
    each); "fp32": one float32 multiply-add outside them; "bf16": x, the taps
    and the output 2 bytes an element, one bf16 product. `backward`: x's
    gradient, the same multiply-adds (MDCL2^T, MDCL1^T); g, x, y and h1 read
    once, dx written once, about twelve elementwise operations per element."""
    n_taps = 9 * (1 + sum(s > 0 for s in scales))
    px = batch * size * size
    elt = 2 if route == "bf16" else 4
    maps = 5 if backward else 2
    nbytes = elt * (maps * px * channels + 2 * n_taps * channels * channels) + 4 * 6 * channels
    macs = 2 * px * n_taps * channels * channels
    other = (12 if backward else 10) * px * channels
    if route != "3xtf32":
        return kernel_bound_ms(nbytes, 2 * macs, other, "bfloat16" if route == "bf16" else "float32")
    # the elementwise operations in TF32-rate units, so that one peak divides both
    return roofline_ms(nbytes, 3 * 2 * macs + other * TF32_OPS_PER_S / FP32_OPS_PER_S, TF32_OPS_PER_S)


def tail_work(batch, cells=256, rr=16, elt=4, trunk_elt=None):
    """(bytes, multiply-add operations, other operations) of the RGB-Beta
    head's autoregressive tail: the G_b (2rr -> 2rr) and B_b (4rr -> 2rr) tap
    products at two operations a multiply-add, and about ten operations for
    each sigmoid and Beta mean."""
    nbytes = (batch * 6 * rr * cells * (trunk_elt or elt)
              + elt * (9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr + batch * 3 * rr * cells))
    return nbytes, batch * cells * 2 * 9 * (2 * rr * 2 * rr + 4 * rr * 2 * rr), batch * cells * 10 * 9 * rr


def rgb_beta_tail_bound_ms(batch, dtype="float32", trunk_elt=None):
    """Least time for the tail's forward: trunk and taps read once, the
    output written once, or its operations, whichever is larger."""
    return kernel_bound_ms(*tail_work(batch, elt=2 if dtype == "bfloat16" else 4, trunk_elt=trunk_elt), dtype)


def rgb_beta_tail_bwd_bound_ms(batch, need_taps=True, dtype="float32", trunk_elt=None, cells=256, rr=16):
    """Least time for the tail's backward: the cotangent, the trunk and the
    taps read once, the trunk's gradient (and with `need_taps` the taps')
    written once; the forward again, B^T and G^T, and with the taps their
    gradients, two operations a multiply-add, and about 30 operations for
    each element's sigmoid, Beta-mean derivative and sigmoid derivative."""
    elt = 2 if dtype == "bfloat16" else 4
    taps = 9 * 2 * rr * 2 * rr + 9 * 4 * rr * 2 * rr
    nbytes = (batch * cells * (3 * rr * elt + 2 * 6 * rr * (trunk_elt or elt))
              + elt * taps * (2 if need_taps else 1))
    products = batch * cells * 2 * taps * (3 if need_taps else 2)
    return kernel_bound_ms(nbytes, products, batch * cells * 30 * 6 * rr, dtype)


def edit_tail_bound_ms(batch, n, radius):
    """Least time for the editor's DELTA / mask / composite tail: each input
    read once, the output written once, or its float32 operations."""
    px = batch * n * n
    nbytes = 4 * (3 * px * 3 + px + px * 3 + 2 * radius + 1)
    ops = px * (10 + 4 * (2 * radius + 1) + 3 + 18)
    return roofline_ms(nbytes, ops)


def staging_bound_ms(n, chw):
    """Least time for the staging kernel: a byte read and four written per
    pixel and one index per row; a multiply and a subtract per pixel."""
    return roofline_ms(n * chw * 5 + 8 * n, 2 * n * chw)


# The port's kernels by the name torch.profiler gives their device records,
# grouped by the function they compute and its direction. A record belongs to
# a group when its base name (namespaces and template arguments dropped) is
# listed and, where several sources use one name, its argument list starts as
# given. float32 forms only: the configurations here are float32.
KERNEL_GROUPS = {
    "mdblock_fwd": (("mdcl_kernel", "float const*, float const*, float const*"),
                    ("add_slices_kernel", "float const*, float const*, float const*, float*")),
    "mdblock_bwd": (("bwd_prologue_kernel", ""), ("mdcl_bwd_kernel", ""), ("add_slices_bwd_kernel", "")),
    "tail_fwd": (("rgb_beta_tail_kernel", ""),),
    "tail_bwd": (("tail_bwd_green_kernel", ""), ("tail_bwd_blue_kernel", ""), ("tail_bwd_blue_t_kernel", ""),
                 ("tail_bwd_red_kernel", ""), ("tail_bwd_taps_kernel", ""), ("tail_bwd_taps_sum_kernel", "")),
    "edit_tail": (("edit_tail_kernel", ""),),
    "staging": (("stage_kernel", ""),),
}


def base_name(record):
    """A device record's kernel name without `void `, namespaces, template
    arguments and argument list."""
    text = re.sub(r"\(anonymous namespace\)::", "", record.removeprefix("void "))
    return text.split("(", 1)[0].split("<", 1)[0].rsplit("::", 1)[-1].strip()


def _arguments(record):
    """The argument list of a demangled kernel name, '' if it has none."""
    text = re.sub(r"\(anonymous namespace\)::", "", record)
    depth, start = 0, None
    for i, ch in enumerate(text):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            start = i
            break
    return "" if start is None else text[start + 1:].rsplit(")", 1)[0].strip()


def kernel_group(record):
    """The KERNEL_GROUPS name of a device record, or None."""
    base = base_name(record)
    if base.endswith("_bf16_kernel") or "bfloat16" in record or "__nv_bfloat16" in record:
        return None
    args = _arguments(record)
    for group, members in KERNEL_GROUPS.items():
        for name, prefix in members:
            if base == name and args.startswith(prefix):
                return group
    return None
