"""The inference MDBLOCK in one kernel call (reference `layers.py:411-416`):

    y = lrelu(BN2(x + MDCL2(lrelu(BN1(MDCL1(lrelu(BN0(x))))))))

with each batch norm folded to a per-channel affine and each MDCL (a base 3x3
plus one dilated 3x3 per scale over one shared filter, `layers.py:207-258`)
written as a sum over its nonzero taps of a shifted slice of the zero-padded
activation times that tap's (Cin, Cout) matrix.

Replaces the Pallas TPU kernel
`npe_tpu/ops/pallas/mdcl_kernels.py:mdblock_fused`. The source is
`npe_tpu_torch/csrc/mdblock.cu` (its header says what bounds it and how the
work is split); `mdblock_taps_reference` is the plain PyTorch version. The
kernel runs both MDCLs on the tensor cores in TF32 with three products per
multiply-add (3xTF32: each operand split into a TF32 high part and a TF32
remainder), which keeps float32 accuracy; `tf32_split` is that split in
PyTorch, for the tests that show why one product would not do.

Layout. x and the output are NCHW as the decoder leaves them. Tap matrices
are (T, Cin, Cout) row-major in the order of `tap_offsets(scales)`, from
`stack_mdcl_taps`, which takes the port's (nf, ni, 3, 3) filters; the kernel
reads them as they lie. The affines are one (6, C) tensor, rows s0, t0, s1,
t1, s2, t2.

One call is a prologue launch, which writes MDCL1's input lrelu(BN0(x))
pixel-major as a TF32 operand pair (hi, lo), then one launch per MDCL: a
producer warp brings tap tiles and halo tiles of the pair by the tensor
memory accelerator, and two consumer warpgroups (on alternate units of one
patch, or once the batch fills the card on a patch each) split each tap
tile into its transposed TF32 pair and run 3xTF32 wgmma. MDCL1 leaves
h1 = lrelu(BN1(MDCL1(..))) as the next pair (and, where x will need a
gradient, NCHW for the backward); MDCL2 adds the raw x. At small batches
the inner dimension is cut into slices summed inside thread-block clusters,
and, where a tile has more slices than a cluster holds, by a launch that
adds the clusters' sums in a fixed order. `fwd_plan` states the cut.

The bfloat16 form (x and the taps in bf16, the affines float32) is a kernel
of its own, `npe_tpu_torch/csrc/mdblock_bf16.cu` (its header has the design):
a prologue launch writes MDCL1's input lrelu(BN0(x)) in bf16, pixel-major,
once per element; each MDCL runs on wgmma with both operands brought into
shared memory by the tensor memory accelerator, the activations as one halo
tile per 8x8 patch and 64-channel chunk shared by all taps, the taps as they
lie. Its tiles and slices come from `bf16_plan`. `mdblock_fused.launches` counts the float32 form's
calls, `mdblock_fused.launches_bf16` the bf16 form's.

x's gradient (npe_tpu's `_fused_bwd`) is hand-written too, in both forms,
in a source of its own (`npe_tpu_torch/csrc/mdblock_bwd.cu`:
`npe_mdblock_bwd`, `npe_mdblock_bwd_bf16`): from a cotangent g of y, and
the h1 and y the forward keeps when autograd will need them,

    g_r  = s2 * lrelu'(a2) * g                  (lrelu'(a2) from the sign of y)
    g_m1 = s1 * lrelu'(a1) * MDCL2^T(g_r)       (lrelu'(a1) from the sign of h1)
    dx   = g_r + s0 * lrelu'(a0) * MDCL1^T(g_m1)   (a0 = s0 * x + t0)

with lrelu'(a) = 1 for a > 0, else 0.2, and MDCL^T the MDCL over the same
offsets whose tap t is the mirrored tap's matrix transposed
(`mdcl_transposed`). g_r and g_m1 are written pixel-major as operand pairs
(TF32 hi and lo in float32, `tf32_split`; bf16 hi and lo in bf16,
`bf16_pair`), and each MDCL^T runs on wgmma over halo tiles of those pairs
and tap tiles as they lie, both brought by the tensor memory accelerator;
at one image its slices are summed inside a thread-block cluster. Its
tiles, stages, slices and clusters come from `bwd_plan`.
`mdblock_backward_reference` is its plain version.
`mdblock_fused.launches_bwd` and `.launches_bwd_bf16` count its calls.
"""

import ctypes
import functools
from collections import namedtuple

import torch
import torch.nn.functional as F

from npe_tpu_torch.ops.kernels import add_launches, build, current_tally
from npe_tpu_torch.ops.kernels.rgb_beta_tail import check_tensors, count_launch, sum_dtype, vjp_of_plain

SOURCE = "npe_tpu_torch/csrc/mdblock.cu"
BF16_SOURCE = "npe_tpu_torch/csrc/mdblock_bf16.cu"
BWD_SOURCE = "npe_tpu_torch/csrc/mdblock_bwd.cu"
REPLACES = "npe_tpu/ops/pallas/mdcl_kernels.py:119"
REPLACES_BWD = "npe_tpu/ops/pallas/mdcl_kernels.py:155"  # `_fused_bwd`, the custom VJP's backward
TILE_PIXELS = 64  # the kernels' output tile: 64 pixels (an 8x8 patch) x 128 channels
TILE_CHANNELS = 128
CHANNEL_STEP = 16  # the channel counts the kernels take are multiples of this
MAX_BRANCHES = 8
# The bf16 kernel: a warpgroup takes a patch of 64 pixels (8x8 in halo mode)
# by 128 or 256 output channels, over units of one tap by 64 input channels
BF16_CHANNEL_STEP = 64
BF16_TILE_CHANNELS = 128  # 256 where the plan takes two patches a block and C >= 256
BF16_MIN_UNITS = 4  # units a slice takes at least: the tap ring's depth
BF16_STAGES, BF16_ROWS_STAGE_BYTES = 4, 64 * 64 * 2
SMEM_PER_BLOCK = 227 * 1024  # the most dynamic shared memory a block may take on the H100
SMEM_PER_SM = 228 * 1024  # what the SM has for its blocks, 1 KB of it reserved per block
# The backward kernels (mdblock_bwd.cu) and the float32 forward's MDCLs
# (mdblock.cu): a unit is one tap by a chunk of 128 bytes of input channels a
# pixel (32 float32, 64 bf16); a tile is an 8x8 patch by 128 (or 256) output
# channels; a tap stage is 16 KB a 128 of them (float32: and its TF32 lo, as
# much again); a halo tile is (8 + 2R)^2 pixels by the chunk.
BWD_CHUNK_BYTES, BWD_TAP_BYTES = 128, 16 * 1024
BWD_STAGES = {False: (3, 4), True: (4, 6)}  # the fewest and the most tap stages: float32, bf16
BWD_MIN_UNITS = 4  # units a slice takes at least
MAX_CLUSTER = 8  # blocks of a cluster, the portable most
# Clusters of n backward blocks (one an SM) the H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters, `npe_mdblock_bwd_clusters`): its GPCs
# fit 15 clusters of 8, not 132 / 8.
CLUSTER_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# What a cluster's second sum launch costs, in units of a slice's work
# (`scripts/kernel_sweep.py mdblock_bwd plan` at full IAN's shapes, batch 1,
# 2 and 8).
BWD_GROUP_COST = 2


def dilations(scales):
    """The 3x3 branches of an MDCL as dilations: the base filter (1; the
    scale-0 branch is folded into its centre), then each scale > 0."""
    return (1,) + tuple(s for s in scales if s > 0)


def tap_offsets(scales):
    """(dy, dx) of every tap, in the order of `stack_mdcl_taps`: nine per
    branch of `dilations(scales)`. The centre appears once per branch."""
    return tuple((dy, dx) for d in dilations(scales) for dy in (-d, 0, d) for dx in (-d, 0, d))


def stack_mdcl_taps(w, coeff_base, scale_coeffs, scales):
    """The (T, Cin, Cout) per-tap matrices for `tap_offsets(scales)`, with the
    per-output-channel coefficients folded in and the scale-0 branch (the
    mean of the nine taps) added to the base filter's centre. w: (nf, ni, 3,
    3) shared filter; scale_coeffs: {scale: (nf,)}. Built from torch ops, so
    gradients reach the weights; one transposed copy of w and one product."""
    nf, ni = w.shape[:2]
    w9 = w.permute(2, 3, 1, 0).reshape(9, ni, nf)
    coeffs = torch.stack([coeff_base] + [scale_coeffs[s] for s in scales if s > 0])  # (B, nf)
    taps = coeffs[:, None, None, :] * w9  # (B, 9, ni, nf)
    if 0 in scales:
        taps[0, 4] += w9.mean(dim=0) * scale_coeffs[0]
    return taps.reshape(-1, ni, nf)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def tap_mirror(n_taps):
    """m(t) for each tap of `tap_offsets`: the tap of the opposite offset,
    9 floor(t / 9) + 8 - t mod 9 (each branch's nine offsets are symmetric)."""
    return [9 * (t // 9) + 8 - t % 9 for t in range(n_taps)]


def _mdcl_taps(h, taps, offs):
    """sum_t shift_t(h) @ taps[t] with a zero border. h: (N, Cin, H, W);
    taps: (T, Cin, Cout). One product per tap."""
    n, c, hh, ww = h.shape
    pad = max(abs(o) for off in offs for o in off)
    hp = F.pad(h, (pad, pad, pad, pad))
    out = 0.0
    for t, (dy, dx) in enumerate(offs):
        sl = hp[:, :, pad + dy : pad + dy + hh, pad + dx : pad + dx + ww]
        out = out + taps[t].t() @ sl.reshape(n, c, hh * ww)
    return out.reshape(n, taps.shape[2], hh, ww)


def mdcl_transposed(g, taps, offs):
    """MDCL^T(g)[ci, p] = sum_t sum_co g[co, p - offset_t] taps[t, ci, co],
    g zero outside the image: the MDCL over the same offsets whose tap t is
    taps[m(t)] transposed (`tap_mirror`). g: (N, Cout, H, W)."""
    return _mdcl_taps(g, taps[tap_mirror(len(offs))].transpose(1, 2), offs)


def mdblock_forward_parts(x, taps1, taps2, affines, scales):
    """(y, h1) of the plain version: its output and the intermediate
    h1 = lrelu(s1 * MDCL1(..) + t1) in x's dtype (NCHW), which the kernels
    keep for the backward."""
    mx, acc = x.dtype, sum_dtype(x.dtype)
    offs = tap_offsets(scales)
    s0, t0, s1, t1, s2, t2 = (a[None, :, None, None] for a in affines)
    xf = x.to(acc)
    h = _lrelu(xf * s0 + t0)
    h1 = _lrelu(_mdcl_taps(h.to(mx).to(acc), taps1.to(acc), offs) * s1 + t1).to(mx)
    h = _mdcl_taps(h1.to(acc), taps2.to(acc), offs)
    return _lrelu((xf + h) * s2 + t2).to(mx), h1


def mdblock_taps_reference(x, taps1, taps2, affines, scales):
    """Plain version of exactly what the kernel computes, and its backward.
    x: (N, C, H, W); taps1, taps2: (T, C, C); affines: (6, C). In bfloat16
    (x and the taps; the affines stay float32) it rounds where npe_tpu's
    kernel rounds: x is widened to float32, each MDCL's input is rounded to
    bf16 just before its products (after BN0's and BN1's affine and lrelu),
    the sums, affines and the residual x + h are float32, and the output is
    rounded to bf16. In float32 every cast is the identity."""
    return mdblock_forward_parts(x, taps1, taps2, affines, scales)[0]


def _slope(a, v):
    """lrelu'(a) * v as torch's VJP of leaky_relu forms it: v where a > 0,
    else v * 0.2 (so 0.2 at a = 0)."""
    return torch.where(a > 0, v, v * 0.2)


def bf16_pair(v):
    """hi + lo with hi = bf16(v) and lo = bf16(v - hi), in float32: the bf16
    backward kernel's operands for the float32 g_r and g_m1, two products
    each into the same float32 sums. hi + lo is exact in float32 and holds v
    to about 16 bits; one bf16 alone would hold 8."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def mdblock_backward_reference(g, x, y, h1, taps1, taps2, affines, scales):
    """Plain version of exactly what the backward kernels compute: x's
    gradient for the cotangent g of y = mdblock(x), given the forward's y and
    h1 (NCHW, x's dtype; `mdblock_forward_parts`):

        g_r = s2 * lrelu'(a2) * g, g_m1 = s1 * lrelu'(a1) * MDCL2^T(g_r),
        dx = g_r + s0 * lrelu'(a0) * MDCL1^T(g_m1)

    with lrelu'(a2) and lrelu'(a1) read from the signs of y and h1, and
    a0 = s0 * x + t0. In float32 it is the VJP of `mdblock_taps_reference`
    up to the order of the sums. In bfloat16 it rounds where the bf16 VJP
    rounds (each MDCL^T's sum, the cotangent of an MDCL's rounded input, to
    bf16; dx once at the end) and also where the kernel does (g_r and g_m1
    split into their `bf16_pair` as the products' operands); the rest is
    float32, g_r in dx's sum included."""
    mx, acc = x.dtype, sum_dtype(x.dtype)
    offs = tap_offsets(scales)
    s0, t0, s1, _, s2, _ = (a[None, :, None, None] for a in affines)

    def rnd(v):
        return v.to(mx).to(acc)

    pair = bf16_pair if mx == torch.bfloat16 else (lambda v: v)
    gr = _slope(y.to(acc), g.to(acc)) * s2
    gm1 = _slope(h1.to(acc), rnd(mdcl_transposed(pair(gr), taps2.to(acc), offs))) * s1
    dx = gr + _slope(x.to(acc) * s0 + t0, rnd(mdcl_transposed(pair(gm1), taps1.to(acc), offs))) * s0
    return dx.to(mx)


def tf32_split(x):
    """(hi, lo) with hi = TF32(x) and lo = TF32(x - hi), as the kernel splits
    each operand: `cvt.rna.tf32.f32` keeps 10 of float32's 23 mantissa bits,
    rounding to nearest with ties away from zero (add half of the last kept
    bit to the magnitude, then clear the 13 dropped bits). float32 in and
    out; hi + lo holds x to about 21 bits. Used by the tests."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = tf32(x)
    return hi, tf32(x - hi)


BF16Plan = namedtuple("BF16Plan", "halo sub_tiles tile_channels splits")


def bf16_smem_bytes(sub_tiles, halo, radius, tile_channels=BF16_TILE_CHANNELS):
    """Dynamic shared memory of one block of the bf16 kernel: the tap ring
    (64 input by `tile_channels` output channels a stage), then per patch
    two halo tiles of (8 + 2 radius)^2 pixels by 64 channels, or (rows mode)
    a ring of 64-pixel windows, then an 8-byte barrier a stage."""
    acts = 2 * (8 + 2 * radius) ** 2 * BF16_CHANNEL_STEP * 2 if halo else BF16_STAGES * BF16_ROWS_STAGE_BYTES
    return BF16_STAGES * (BF16_CHANNEL_STEP * tile_channels * 2 + 8) + sub_tiles * acts


def bf16_plan(batch, channels, height, width, scales, sm_count):
    """How the bf16 kernel cuts one MDCL (a stated rule, the same on every
    call of a shape):
    - halo: 8x8 patches that share one halo tile among all taps, when both
      sides are multiples of 8 and two patches' halo tiles fit a block;
      else rows mode, 64 consecutive pixels with a window staged per tap;
    - sub_tiles: two patches a block (two warpgroups over the same tap
      stages, half the taps' traffic) once the output tiles (patches x
      128-channel tiles) give every SM two; else one;
    - tile_channels: with two patches a block and C >= 256, 256 output
      channels a block (wgmma's widest N: half the products' issue a
      multiply-add), where its shared memory fits; else 128;
    - splits: slices of the inner dimension (chunks of 64 channels x taps)
      so that the blocks fill the card's slots (one block of two patches or,
      where shared memory allows, two of one a multiprocessor), each slice
      at least BF16_MIN_UNITS units; one once the batch fills the card."""
    radius = max(dilations(scales))
    halo = height % 8 == 0 and width % 8 == 0 and bf16_smem_bytes(2, True, radius) <= SMEM_PER_BLOCK
    patches = batch * height * width // TILE_PIXELS
    sub = 2 if patches * -(-channels // BF16_TILE_CHANNELS) >= 2 * sm_count else 1
    wide = sub == 2 and channels >= 256 and bf16_smem_bytes(2, halo, radius, 256) <= SMEM_PER_BLOCK
    tile_channels = 256 if wide else BF16_TILE_CHANNELS
    per_sm = 1 if sub == 2 else min(2, SMEM_PER_SM // (bf16_smem_bytes(1, halo, radius) + 1024))
    blocks = -(-patches // sub) * -(-channels // tile_channels)
    units = -(-channels // BF16_CHANNEL_STEP) * 9 * len(dilations(scales))
    splits = max(1, min(units // BF16_MIN_UNITS, per_sm * sm_count // blocks))
    return BF16Plan(halo, sub, tile_channels, splits)


BwdPlan = namedtuple("BwdPlan", "sub_tiles tile_channels stages halo_buffers splits cluster smem")


def bwd_smem_bytes(bf16, sub_tiles, stages, halo_buffers, radius, tile_channels=TILE_CHANNELS):
    """Dynamic shared memory of one block of the backward kernel: the tap
    ring (a stage of `tile_channels` output channels), per patch
    `halo_buffers` pairs of (hi, lo) halo tiles, and two 8-byte barriers a
    stage (room for eight)."""
    halo = (8 + 2 * radius) ** 2 * BWD_CHUNK_BYTES
    tap = BWD_TAP_BYTES * tile_channels // TILE_CHANNELS * (1 if bf16 else 2)
    return stages * tap + sub_tiles * halo_buffers * 2 * halo + 2 * 8 * 8


def slice_plan(units, tiles, sm_count):
    """(splits, cluster) of an MDCL of `units` units over `tiles` blocks of
    one patch each, as `bwd_plan` and `fwd_plan` cut it: among the cuts whose
    blocks run at once (at most one an SM, and at most
    CLUSTER_SLOTS[cluster] clusters) with at least BWD_MIN_UNITS units a
    slice, the one with the least units a slice plus BWD_GROUP_COST per
    group past the first; ties to the larger cluster; (1, 1) where none
    beats one slice."""
    best = (units, -1, 1, 1)  # (cost, -cluster, splits, cluster): one slice
    for splits in range(2, units // BWD_MIN_UNITS + 1):
        for cluster in range(1, min(MAX_CLUSTER, splits) + 1):
            if splits % cluster or tiles * splits > sm_count or \
                    tiles * splits // cluster > min(CLUSTER_SLOTS[cluster], sm_count // cluster):
                continue
            cost = -(-units // splits) + BWD_GROUP_COST * (splits // cluster - 1)
            best = min(best, (cost, -cluster, splits, cluster))
    return best[2:]


def bwd_plan(batch, channels, height, width, scales, dtype, sm_count):
    """How the backward kernel cuts each MDCL^T (a stated rule, the same on
    every call of a shape):
    - tiles: 8x8 patches (partial ones masked) by `tile_channels` output
      channels;
    - sub_tiles: in bf16, two patches a block over the same tap stages once
      the tiles give every SM two; else one (float32 always: its consumers
      split the tap tile);
    - tile_channels: with two patches a block and C >= 256, 256 output
      channels a block (half the tap tiles' traffic a product) where its
      ring fits beside one halo buffer; else 128;
    - halo_buffers, stages: two halo buffers (the next chunk's tiles land
      while this one's taps run) and as many tap stages as fit 227 KB
      (float32 3 to 4, bf16 4 to 6); in bf16 one halo buffer where two do not
      fit; ValueError if nothing fits;
    - splits, cluster: slices of the units (chunks x taps), the slices of a
      tile cut into groups of `cluster` blocks, each group summed in one
      cluster's shared memory and the groups, where there are more than one,
      by a second launch: `slice_plan`. One slice once two patches share a
      block (the batch fills the card)."""
    bf16 = dtype in (torch.bfloat16, "bfloat16")
    radius = max(dilations(scales))
    patches = batch * -(-height // 8) * -(-width // 8)
    tiles_c = -(-channels // TILE_CHANNELS)
    units = -(-channels * (2 if bf16 else 4) // BWD_CHUNK_BYTES) * 9 * len(dilations(scales))
    sub = 2 if bf16 and patches * tiles_c >= 2 * sm_count else 1
    fewest, most = BWD_STAGES[bf16]
    wide = sub == 2 and channels >= 256 and bwd_smem_bytes(bf16, sub, fewest, 1, radius, 256) <= SMEM_PER_BLOCK
    tile_channels = 256 if wide else TILE_CHANNELS
    for halo_buffers in (2, 1) if bf16 else (2,):
        fits = [n for n in range(most, fewest - 1, -1)
                if bwd_smem_bytes(bf16, sub, n, halo_buffers, radius, tile_channels) <= SMEM_PER_BLOCK]
        if fits:
            break
    else:
        raise ValueError(f"mdblock's backward: a halo of radius {radius} does not fit a block's shared memory")
    tiles = -(-patches // sub) * -(-channels // tile_channels)
    splits, cluster = slice_plan(units, tiles, sm_count) if sub == 1 else (1, 1)
    return BwdPlan(sub, tile_channels, fits[0], halo_buffers, splits, cluster,
                   bwd_smem_bytes(bf16, sub, fits[0], halo_buffers, radius, tile_channels))


FwdPlan = namedtuple("FwdPlan", "halo sub_tiles stages splits cluster smem")


def fwd_smem_bytes(halo, stages, radius, sub_tiles=1):
    """Dynamic shared memory of one MDCL block of the float32 forward: the tap
    ring (a stage of 32 x 128 taps as they land, then split into TF32 hi in
    place and lo beside it), the pair's activations (`halo`: per patch two
    buffers of (hi, lo) halo tiles, one with two patches a block; else one
    8x8 window pair a stage), and two 8-byte barriers a stage (room for
    eight)."""
    buffers = (2 if sub_tiles == 1 else 1) if halo else stages
    return bwd_smem_bytes(False, sub_tiles, stages, buffers, radius if halo else 0)


def fwd_plan(batch, channels, height, width, scales, sm_count):
    """How the float32 forward cuts each MDCL (a stated rule, the same on
    every call of a shape):
    - tiles: 8x8 patches (partial ones masked) by 128 output channels;
    - sub_tiles: two patches a block over the same tap stages (half the tap
      tiles' traffic a product) once the tiles give every SM two and one
      halo buffer a patch fits beside three tap stages; else one;
    - halo, stages: halo tiles shared by all taps of a chunk (one patch: in
      two buffers), and as many tap stages (3 or 4) as fit 227 KB with
      them; where none fit (a dilation past 4), a stage brings each unit's
      own shifted window (`halo` False), 4 stages;
    - splits, cluster: with one patch a block, `slice_plan` of the units
      (chunks of 32 input channels x taps) over the tiles, as the backward
      cuts its MDCL^T; one slice with two."""
    radius = max(dilations(scales))
    fewest, most = BWD_STAGES[False]
    patches = batch * -(-height // 8) * -(-width // 8)
    tiles_c = -(-channels // TILE_CHANNELS)
    sub = 2 if patches * tiles_c >= 2 * sm_count and fwd_smem_bytes(True, fewest, radius, 2) <= SMEM_PER_BLOCK else 1
    for halo in (True, False):
        fits = [n for n in range(most, fewest - 1, -1) if fwd_smem_bytes(halo, n, radius, sub) <= SMEM_PER_BLOCK]
        if fits:
            break
    units = -(-channels * 4 // BWD_CHUNK_BYTES) * 9 * len(dilations(scales))
    splits, cluster = slice_plan(units, patches * tiles_c, sm_count) if sub == 1 else (1, 1)
    return FwdPlan(halo, sub, fits[0], splits, cluster, fwd_smem_bytes(halo, fits[0], radius, sub))


def fwd_launches(plan):
    """Launches of one float32 forward call on `plan`: the prologue and the
    two MDCLs, and after each MDCL its clusters' sum where a tile's slices
    outnumber a cluster."""
    return 3 if plan.splits == plan.cluster else 5


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry(bf16, backward=False):
    """The C entry point of a form (`npe_mdblock[_bf16]`, `npe_mdblock_bwd[_bf16]`)."""
    lib = build.load("mdblock_bwd" if backward else "mdblock_bf16" if bf16 else "mdblock")
    fn = getattr(lib, "npe_mdblock" + ("_bwd" if backward else "") + ("_bf16" if bf16 else ""))
    if backward:  # g, x, y, h1, taps1, taps2, aff, gr, gm1, partial, dx; the shape; dilations; the BwdPlan
        fn.argtypes = [_P] * 11 + [_I] * 5 + [_P] + [_I] * 6 + [_P]
    elif bf16:  # x, taps1, taps2, aff, act, h1, partial, out; the shape; dilations; the BF16Plan
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_P] + [_I] * 4 + [_P]
    else:  # x, taps1, taps2, aff, act, h1_pair, h1, partial, out; the shape; dilations; the FwdPlan
        fn.argtypes = [_P] * 9 + [_I] * 5 + [_P] + [_I] * 5 + [_P]
    fn.restype = ctypes.c_int
    return fn


def bwd_launches(plan):
    """Launches of one backward call on `plan`: the prologue and the two
    MDCL^T, and after each of those its clusters' sum where a tile's slices
    outnumber a cluster."""
    return 3 if plan.splits == plan.cluster else 5


def _sms(x):
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _partial(x, splits):
    """Float32 partial sums of `splits` slices, or None for one."""
    return torch.empty((x.shape[0], splits, *x.shape[1:]), dtype=torch.float32, device=x.device) if splits > 1 else None


def _call(fn, x, *args):
    """fn(*args, stream) on x's device, tensors as their addresses, a
    tuple as a C int array."""
    def arg(a):
        if isinstance(a, torch.Tensor):
            return a.data_ptr()
        return (ctypes.c_int * len(a))(*a) if isinstance(a, tuple) else a

    with torch.cuda.device(x.device):
        return fn(*map(arg, args), torch.cuda.current_stream(x.device).cuda_stream)


def _launch_float32(x, taps1, taps2, affines, scales, keep_h1=True, plan=None):
    """The float32 kernel's call on `plan` (default `fwd_plan`'s): scratch
    for the operand pairs of MDCL1's and MDCL2's inputs (pixel-major, the lo
    images after the hi) and, where a tile's slices outnumber a cluster,
    float32 partial sums of the clusters. Returns (the output, h1 as
    (N, C, H, W) for the backward, or None without `keep_h1`, the C
    function's return code)."""
    n, c, h, w = x.shape
    branches = dilations(scales)
    if plan is None:
        plan = fwd_plan(n, c, h, w, scales, _sms(x))
    pairs = torch.empty((2, 2, n, h, w, c), dtype=x.dtype, device=x.device)
    h1 = torch.empty_like(x) if keep_h1 else None
    out = torch.empty_like(x)
    rc = _call(_entry(False), x, x, taps1, taps2, affines, pairs[0], pairs[1], h1,
               _partial(x, plan.splits // plan.cluster), out, n, c, h, w, len(branches), branches, int(plan.halo),
               *plan[1:5])
    return out, h1, rc


def _launch_bf16(x, taps1, taps2, affines, scales, keep_h1=True):
    """The bf16 kernel's call: scratch for MDCL1's input and h1 (bf16,
    pixel-major: MDCL2's operand, so made whatever `keep_h1` says), float32
    partial sums when `bf16_plan` slices; the taps as they lie. Returns (the
    output, h1 as (N, H, W, C), the C function's return code)."""
    n, c, h, w = x.shape
    branches, plan = dilations(scales), bf16_plan(n, c, h, w, scales, _sms(x))
    act, out = torch.empty_like(x), torch.empty_like(x)
    h1 = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    rc = _call(_entry(True), x, x, taps1, taps2, affines, act, h1, _partial(x, plan.splits), out, n, c, h, w,
               len(branches), branches, plan.sub_tiles, int(plan.halo), plan.tile_channels, plan.splits)
    return out, h1, rc


def _launch_bwd(g, x, y, h1, taps1, taps2, affines, scales, plan=None):
    """The backward's call on `plan` (default `bwd_plan`'s): scratch for the
    operand pairs of g_r and g_m1 (pixel-major, the lo images after the hi)
    and, where a tile's slices outnumber a cluster, float32 partial sums of
    the clusters; h1 in the forward's layout (float32 NCHW, bf16 NHWC).
    Returns (dx, the C function's return code)."""
    n, c, h, w = x.shape
    branches = dilations(scales)
    if plan is None:
        plan = bwd_plan(n, c, h, w, scales, x.dtype, _sms(x))
    gr, gm1 = (torch.empty((2, n, h, w, c), dtype=x.dtype, device=x.device) for _ in range(2))
    dx = torch.empty_like(x)
    rc = _call(_entry(x.dtype == torch.bfloat16, True), x, g, x, y, h1, taps1, taps2, affines, gr, gm1,
               _partial(x, plan.splits // plan.cluster), dx, n, c, h, w, len(branches), branches, *plan[:6])
    return dx, rc


class _MDBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps1, taps2, affines, scales):
        bf16 = x.dtype == torch.bfloat16
        keep = ctx.needs_input_grad[0]
        out, h1, rc = (_launch_bf16 if bf16 else _launch_float32)(x, taps1, taps2, affines, scales, keep)
        if rc != 0:
            raise RuntimeError(f"mdblock kernel launch failed with CUDA error {rc}")
        count_launch(mdblock_fused, x.dtype)
        # h1 (in the form's layout) and y only where x requires a gradient;
        # under no_grad or inference_mode autograd drops ctx, and all it saved,
        # as this call returns
        ctx.save_for_backward(x, taps1, taps2, affines, *((h1, out) if keep else ()))
        ctx.scales = scales
        # autograd may run the backward on a thread of its own: it counts where the forward did
        ctx.tally = current_tally()
        return out

    @staticmethod
    def backward(ctx, g):
        x, taps1, taps2, affines, *kept = ctx.saved_tensors
        need_x, *need_rest = ctx.needs_input_grad[:4]
        dx = None
        if need_x:
            bf16 = x.dtype == torch.bfloat16
            h1, y = kept
            dx, rc = _launch_bwd(g.to(x.dtype).contiguous(), x, y, h1, taps1, taps2, affines, ctx.scales)
            if rc != 0:
                raise RuntimeError(f"mdblock backward kernel launch failed with CUDA error {rc}")
            add_launches(mdblock_fused, "launches_bwd_bf16" if bf16 else "launches_bwd", tally=ctx.tally)
        rest = (None,) * 3
        if any(need_rest):  # the taps' and affines' gradients: the plain version's VJP
            plain = functools.partial(mdblock_taps_reference, scales=ctx.scales)
            rest = vjp_of_plain(plain, (False, *need_rest), (x, taps1, taps2, affines), g)[1:]
        return (dx, *rest, None)


def mdblock_fused(x, taps1, taps2, affines, scales):
    """Fused inference MDBLOCK. x: (N, C, H, W), C a multiple of 16 and
    H*W a multiple of 64; taps1, taps2: (T, C, C) from `stack_mdcl_taps`, in
    x's dtype, float32 (the float32 form) or bfloat16 (the bf16 form:
    `mdblock_taps_reference` says where it rounds); affines: (6, C) float32,
    rows s0, t0, s1, t1, s2, t2; scales: the MDCLs' scale list, e.g. (0, 2,
    3), not tensor data. Returns (N, C, H, W) in x's dtype. Only the inputs
    that need a gradient get one. x's comes from the backward kernels
    (`mdblock_backward_reference` is their plain version), for which the
    forward keeps h1 and y when x requires a gradient; the taps'
    and affines', which no inference path asks for (the edit step and
    `imgrad` ask for x's alone), are the plain version's VJP."""
    scales = tuple(int(s) for s in scales)
    branches = dilations(scales)
    if x.ndim != 4 or x.shape[0] < 1 or x.shape[1] % CHANNEL_STEP or (x.shape[2] * x.shape[3]) % TILE_PIXELS:
        raise ValueError(
            f"mdblock_fused wants (N, C, H, W) with C a multiple of {CHANNEL_STEP} and H*W a multiple "
            f"of {TILE_PIXELS}, got {tuple(x.shape)}"
        )
    if len(branches) > MAX_BRANCHES or min(scales, default=0) < 0:
        raise ValueError(f"mdblock_fused takes scales >= 0, at most {MAX_BRANCHES - 1} of them dilated; got {scales}")
    c = x.shape[1]
    check_tensors(
        "mdblock_fused",
        {"x": x, "taps1": taps1, "taps2": taps2, "affines": affines},
        {"x": x.shape, "taps1": (9 * len(branches), c, c), "taps2": (9 * len(branches), c, c),
         "affines": (6, c)},
        float32=("affines",),
    )
    if x.device.type == "cpu":
        return mdblock_taps_reference(x, taps1, taps2, affines, scales)
    return _MDBlock.apply(x, taps1, taps2, affines, scales)


mdblock_fused.launches = 0
mdblock_fused.launches_bf16 = 0
mdblock_fused.launches_bwd = 0
mdblock_fused.launches_bwd_bf16 = 0
