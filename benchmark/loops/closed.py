"""A closed loop of one caller: each request is issued when the one
before it has returned; the window ends when the last request issued
before the deadline has returned.  A request's time runs from its issue
to its return."""

from __future__ import annotations

import time


def run(wl, call, seconds: float, probe) -> tuple[list, float]:
    """Drives ``call`` over ``wl``'s requests for ``seconds``; returns
    (each request's host seconds, the window's seconds).  ``probe`` is
    told the seconds elapsed before each request and each request's key
    and output after it."""
    times = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    now = t0
    while now < deadline:
        probe.before(now - t0)
        key, inp = wl.draw()
        out = call(inp)
        wl.keep(len(times), key, out)
        probe.after(key, out)
        t = time.perf_counter()
        times.append(t - now)
        now = t
    probe.close()
    return times, now - t0
