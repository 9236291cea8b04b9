"""Per-stage host timing and device traces.

The port's copy of imageencoder_tpu/utils/profiling.py.  Library stages
mark themselves with the ambient ``stage()``, which is free unless a
:func:`tracing` scope is active; then its wall time lands in that scope's
``stages`` list as (label, seconds), and :meth:`Trace.report` writes the
table through the Logger (the CLI's ``--trace``):

    with tracing("decode", pixels=w * h) as t:
        decode_image(data)          # its stage() calls report to t
    t.report()

    with device_trace("/tmp/trace"):   # torch.profiler, CPU and CUDA
        run()

A stage's time is the host's: work the device runs after the stage has
returned is not in it.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

from .logger import Logger


class Trace:
    def __init__(self, name: str, pixels: int | None = None):
        self.name = name
        self.pixels = pixels
        self.stages: list[tuple[str, float]] = []
        self._t0 = None
        self.total = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total = time.perf_counter() - self._t0
        return False

    @contextlib.contextmanager
    def stage(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((label, time.perf_counter() - t0))

    def report(self) -> None:
        for label, dt in self.stages:
            Logger.write(f"[trace:{self.name}] {label}: {dt * 1e3:.2f} ms")
        if self.total:
            msg = f"[trace:{self.name}] total: {self.total * 1e3:.2f} ms"
            if self.pixels:
                msg += f" ({self.pixels / self.total / 1e6:.1f} Mpix/s)"
            Logger.write(msg)


_CURRENT: Trace | None = None


def current() -> Trace | None:
    """The innermost active tracing() scope, or None."""
    return _CURRENT


@contextlib.contextmanager
def tracing(name: str, pixels: int | None = None):
    """Collect the stage() marks made inside the block."""
    global _CURRENT
    t, prev = Trace(name, pixels), _CURRENT
    _CURRENT = t
    try:
        with t:
            yield t
    finally:
        _CURRENT = prev


@contextlib.contextmanager
def stage(label: str):
    """Mark a library stage; records into the active trace, if any."""
    t = _CURRENT
    if t is None:
        yield
    else:
        with t.stage(label):
            yield


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace of the block: the host's operations and,
    where there is a card, its kernels and copies, written as a Chrome
    trace to ``logdir``/trace.json.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
