"""The device's idle share of the traced window, %: 1 - (the union of the
intervals in which an operation ran on the device) / (the window)."""


def read(run):
    if run.profile is None or run.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / run.profile.window_s)
