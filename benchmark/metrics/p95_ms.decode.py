"""The 95th percentile (nearest rank) of the host milliseconds of every
decode request of the traced window, each from its issue to its return:
the decode's tail, read per layer (on the host's clock a one-card
machine's stalls move it by more than half of any bound it could have)."""

import math


def read(run):
    if run.direction != "decode" or not run.times:
        return None
    ms = sorted(run.times)
    return 1e3 * ms[math.ceil(0.95 * len(ms)) - 1]
