"""The device's idle share over the profiled stretch of a decode cell:
100 x (1 - busy / stretch), busy the union of kernel, copy and fill
intervals."""


def read(run):
    p = run.profile
    if run.direction != "decode" or p is None or p.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
