"""The RGB-Beta tail kernels' share of their roofline, %: the least time of
the forward and backward launches the traced window ran, over the union of
the device intervals of those kernels. The launches are counted by name in
the trace: a forward is one `rgb_beta_tail_kernel`; a backward is one
`tail_bwd_green_kernel`, its first pass, and asked for the taps' gradients
as well where it also ran a `tail_bwd_taps_kernel`."""

from benchmark.yardstick.bounds import base_name, kernel_group, rgb_beta_tail_bound_ms, rgb_beta_tail_bwd_bound_ms


def launches(run, group, kernel):
    return run.profile.count(lambda name: kernel_group(name) == group and base_name(name) == kernel)


def read(run):
    if run.profile is None:
        return None
    seconds, n = run.profile.kernel_seconds(lambda name: kernel_group(name) in ("tail_fwd", "tail_bwd"))
    fwd = launches(run, "tail_fwd", "rgb_beta_tail_kernel")
    bwd = launches(run, "tail_bwd", "tail_bwd_green_kernel")
    taps = launches(run, "tail_bwd", "tail_bwd_taps_kernel")
    if not (fwd or bwd) or not n or seconds <= 0:
        return None
    least_ms = (fwd * rgb_beta_tail_bound_ms(run.batch)[0]
                + taps * rgb_beta_tail_bwd_bound_ms(run.batch, need_taps=True)[0]
                + (bwd - taps) * rgb_beta_tail_bwd_bound_ms(run.batch, need_taps=False)[0])
    return 100.0 * least_ms / 1e3 / seconds
