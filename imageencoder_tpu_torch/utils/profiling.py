"""Per-stage host timing.

The port's copy of imageencoder_tpu/utils/profiling.py's ambient
``stage()`` marks: a stage is free unless a :func:`tracing` scope is
active, and then its wall time lands in that scope's ``stages`` list as
(label, seconds).
"""

from __future__ import annotations

import contextlib
import time


class Trace:
    def __init__(self, name: str):
        self.name = name
        self.stages: list[tuple[str, float]] = []


_CURRENT: Trace | None = None


@contextlib.contextmanager
def tracing(name: str):
    """Collect the stage() marks made inside the block."""
    global _CURRENT
    t, prev = Trace(name), _CURRENT
    _CURRENT = t
    try:
        yield t
    finally:
        _CURRENT = prev


@contextlib.contextmanager
def stage(label: str):
    """Mark a library stage; records into the active trace, if any."""
    t = _CURRENT
    if t is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t.stages.append((label, time.perf_counter() - t0))
