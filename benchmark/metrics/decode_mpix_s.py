"""Luma pixels of every decode request of the window over the window's
seconds, in millions a second."""


def read(run):
    if run.direction != "decode" or run.window_s <= 0.0:
        return None
    return len(run.times) * run.workload.pixels / run.window_s / 1e6
