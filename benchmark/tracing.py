"""What a traced run reads: the program's spans and the device's
operations.

Spans.  The program marks its stages with ``utils/profiling.stage()``,
which reports to the active ``tracing()`` scope.  :func:`program_spans`
opens that scope and has each stage recorded with its start and end on
the host clock, and as a ``torch.profiler.record_function`` so that the
profiler's timeline holds it too.  The harness adds its own span,
``request``, around each call.

Device.  :func:`read_profile` takes a ``torch.profiler`` run over a
stretch of the window and returns the device's operations (kernels,
copies, fills) and the host's spans as intervals on one clock.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

SPAN_PREFIX = "span:"
STRETCH = "bench:profiled"


class Spans:
    """Host spans: (label, start s, end s), in the order they closed."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + label):
            try:
                yield
            finally:
                self.records.append((label, t0, time.perf_counter()))


@contextlib.contextmanager
def program_spans(spans: Spans):
    """The program's stage() marks recorded into ``spans`` for the
    block."""
    from imageencoder_tpu_torch.utils import profiling

    with profiling.tracing("benchmark") as scope:
        scope.stage = spans.span  # the scope's stage(): what marks call
        yield


def _device_kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "copy"
    if low.startswith("memset"):
        return "fill"
    return "kernel"


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


class Profile:
    """One profiled stretch: device operations [(name, kind, start,
    end)], host spans [(label, start, end)], the stretch (start, end),
    all in seconds on the profiler's clock, and the launches the host
    made (the runtime's launch calls)."""

    def __init__(self, ops, spans, stretch, launches: int):
        self.ops, self.spans, self.stretch = ops, spans, stretch
        self.launches = launches

    @property
    def window_s(self) -> float:
        return self.stretch[1] - self.stretch[0]

    def clipped(self, kinds=None) -> list[tuple[float, float]]:
        a, b = self.stretch
        return merge((max(s, a), min(e, b)) for _, k, s, e in self.ops
                     if (kinds is None or k in kinds) and e > a and s < b)

    def busy_s(self) -> float:
        return length(self.clipped())

    def kernel_s(self) -> float:
        return length(self.clipped({"kernel"}))

    def kernels(self) -> int:
        return sum(1 for _, k, _, _ in self.ops if k == "kernel")

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time, by name."""
        by: dict[str, float] = {}
        for name, _, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_span(self, n: int = 10) -> list:
        """The device's idle time in the stretch, by the innermost host
        span open while it lasted ("harness" where none was)."""
        a, b = self.stretch
        busy = self.clipped()
        gaps, t = [], a
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < b:
            gaps.append((t, b))
        spans = sorted(self.spans, key=lambda x: x[1])
        starts = [s for _, s, _ in spans]
        longest = max((e - s for _, s, e in spans), default=0.0)
        by: dict[str, float] = {}
        for g0, g1 in gaps:
            lo = bisect.bisect_left(starts, g0 - longest)
            hi = bisect.bisect_left(starts, g1)
            live = [x for x in spans[lo:hi] if x[2] > g0]
            cuts = sorted({g0, g1} | {p for _, s, e in live for p in (s, e)
                                      if g0 < p < g1})
            for c0, c1 in zip(cuts, cuts[1:]):
                mid = 0.5 * (c0 + c1)
                inner = [x for x in live if x[1] <= mid < x[2]]
                label = max(inner, key=lambda x: x[1])[0] if inner \
                    else "harness"
                by[label] = by.get(label, 0.0) + (c1 - c0)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def read_profile(prof) -> Profile:
    """A :class:`Profile` of a finished ``torch.profiler.profile`` whose
    stretch was marked by ``record_function(STRETCH)``."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    ops, spans, stretch, launches = [], [], None, 0
    for ev in results.events():
        name = ev.name()
        s = (ev.start_ns() - base) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            if not (ev.is_user_annotation() or name.startswith(
                    (SPAN_PREFIX, STRETCH))):  # the host's spans mirrored
                ops.append((name, _device_kind(name), s, e))
        elif name == STRETCH:
            stretch = (s, e)
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], s, e))
        elif name in LAUNCH_CALLS:
            launches += 1
    if stretch is None:
        raise RuntimeError("the profile holds no marked stretch")
    return Profile(ops, spans, stretch, launches)
