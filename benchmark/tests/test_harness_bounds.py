"""The benchmark's frozen bounds reproduce the values of PERF.md's kernel
table, and its kernel-name table sorts the profiler's records."""

import pytest

from benchmark.yardstick import bounds as B

MDBLOCK_SHAPES = ((512, 8, (0, 2)), (256, 16, (0, 2, 3)), (128, 32, (0, 2, 3)))


def close(got, want):
    """got rounds to `want` as PERF.md prints it (half a unit of its last
    digit, and a little more)."""
    text = repr(want) if "e" not in repr(want) else f"{want:.10f}".rstrip("0")
    decimals = len(text.split(".")[1]) if "." in text else 0
    return abs(got - want) <= 0.6 * 10 ** -decimals


@pytest.mark.parametrize("batch,backward,want", [
    (1, False, (0.011350, 0.010991, 0.011001)),
    (1, True, (0.011468, 0.010993, 0.011005)),
    (8, True, (0.058615, 0.087946, 0.088039)),
    (128, True, (0.937835, 1.407128, 1.408631)),
])
def test_mdblock_bounds(batch, backward, want):
    got = [B.mdblock_bound_ms(batch, c, hw, s, backward=backward)[0] for c, hw, s in MDBLOCK_SHAPES]
    assert all(close(g, w) for g, w in zip(got, want)), got
    if batch == 1 and not backward:
        assert close(sum(got), 0.03334)
        assert [B.mdblock_bound_ms(1, c, hw, s)[1] for c, hw, s in MDBLOCK_SHAPES] == ["bytes", "operations",
                                                                                         "operations"]


@pytest.mark.parametrize("fn,args,want", [
    (B.rgb_beta_tail_bound_ms, (1,), 0.000217),
    (B.rgb_beta_tail_bwd_bound_ms, (1, False), 0.000434),
    (B.rgb_beta_tail_bwd_bound_ms, (16, False), 0.006937),
    (B.rgb_beta_tail_bwd_bound_ms, (1, True), 0.000645),
    (B.rgb_beta_tail_bwd_bound_ms, (16, True), 0.010318),
    (B.rgb_beta_tail_bwd_bound_ms, (128, True), 0.082540),
    (B.edit_tail_bound_ms, (1, 64, 3), 0.0000636),
    (B.staging_bound_ms, (8192, 3 * 64 * 64), 0.150263),
    (B.staging_bound_ms, (1024, 3 * 64 * 64), 0.018783),
])
def test_kernel_bounds(fn, args, want):
    assert close(fn(*args)[0], want), fn(*args)


@pytest.mark.parametrize("record,group", [
    ("(anonymous namespace)::mdcl_kernel(float const*, float const*, float const*, "
     "(anonymous namespace)::Branches, float*, float const*, float const*, int, int, int, int)", "mdblock_fwd"),
    ("(anonymous namespace)::add_slices_kernel(float const*, float const*, float const*, float*, int, int, int)",
     "mdblock_fwd"),
    ("(anonymous namespace)::add_slices_kernel(float const*, float*, int, int)", None),
    ("void (anonymous namespace)::mdcl_bwd_kernel<float, 2>((anonymous namespace)::Bwd<float>, CUtensorMap, "
     "CUtensorMap)", "mdblock_bwd"),
    ("void (anonymous namespace)::mdcl_bwd_kernel<__nv_bfloat16, 2>((anonymous namespace)::Bwd<__nv_bfloat16>, "
     "CUtensorMap, CUtensorMap)", None),
    ("void (anonymous namespace)::bwd_prologue_kernel(float const*, float const*, float const*, float*, int, int)",
     "mdblock_bwd"),
    ("void npe::rgb_beta_tail_kernel<float, float, false>(float const*, float const*, float const*, float*, int, "
     "int, int)", "tail_fwd"),
    ("void npe::tail_bwd_green_kernel<float, float, false>(npe::TailBwdArgs<float, float>)", "tail_bwd"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true>(...)", None),
    ("Memcpy HtoD (Pinned -> Device)", None),
])
def test_kernel_groups(record, group):
    assert B.kernel_group(record) == group
