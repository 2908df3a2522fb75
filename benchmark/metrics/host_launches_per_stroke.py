"""The host's launch calls (kernels, graph launches, copies, sets) per
stroke in the traced window, from the profiler's record of the CUDA API."""


def read(run):
    if run.profile is None or not run.work:
        return None
    return run.profile.launches / run.work
