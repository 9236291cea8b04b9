"""The 95th percentile (nearest rank) of the host milliseconds of every
encode request of the window, each from its issue to its return."""

import math


def read(run):
    if run.direction != "encode" or not run.times:
        return None
    ms = sorted(run.times)
    return 1e3 * ms[math.ceil(0.95 * len(ms)) - 1]
