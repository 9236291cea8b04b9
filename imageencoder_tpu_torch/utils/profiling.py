"""Per-stage host spans, counters and device traces.

The port's copy of imageencoder_tpu/utils/profiling.py.  Library stages
mark themselves with the ambient ``stage()``, and count what they move
with the ambient ``count()``; both are free unless a :func:`tracing`
scope is active.  Then each stage lands in that scope's ``records`` as
(label, start ns, end ns, parent), ``parent`` the index of the enclosing
stage still open (-1 at top level), and runs as a
``torch.profiler.record_function`` range, so that a :func:`device_trace`
holds the program's stages beside the kernels and copies on the
profiler's own clock.  :meth:`Trace.report` writes the stages as a tree
and the counters through the Logger (the CLI's ``--trace``):

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

from torch.profiler import record_function

from .logger import Logger

_clock = time.perf_counter_ns


class Trace:
    def __init__(self, name: str, pixels: int | None = None):
        self.name = name
        self.pixels = pixels
        # (label, start ns, end ns, parent index), in the order opened;
        # an open stage's end is None.
        self.records: list[tuple] = []
        self.counters: dict[str, int] = {}
        self._open = -1
        self._t0 = None
        self.total = 0.0

    def __enter__(self):
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.total = (_clock() - self._t0) * 1e-9
        return False

    @contextlib.contextmanager
    def stage(self, label: str):
        parent, i = self._open, len(self.records)
        with record_function(label):
            t0 = _clock()
            self.records.append((label, t0, None, parent))
            self._open = i
            try:
                yield
            finally:
                self.records[i] = (label, t0, _clock(), parent)
                self._open = parent

    @property
    def stages(self) -> list[tuple[str, float]]:
        """(label, seconds) of every closed stage, in the order opened."""
        return [(label, (e - s) * 1e-9) for label, s, e, _ in self.records
                if e is not None]

    def tree(self) -> list[tuple[int, str, int, float, float]]:
        """The stages summed by label under the same chain of parents, in
        the order first opened, depth first: (depth, label, calls, total
        s, self s), self being the total less the direct children's."""
        paths, nodes, children = [], {}, {}
        for label, s, e, parent in self.records:
            path = (paths[parent] if parent >= 0 else ()) + (label,)
            paths.append(path)
            if e is None:
                continue
            if path not in nodes:
                nodes[path] = [0, 0.0, 0.0]
                children.setdefault(path[:-1], []).append(path)
            node, dt = nodes[path], (e - s) * 1e-9
            node[0] += 1
            node[1] += dt
            node[2] += dt
            if path[:-1] in nodes:
                nodes[path[:-1]][2] -= dt
        out, todo = [], children.get((), [])[::-1]
        while todo:
            path = todo.pop()
            calls, total, own = nodes[path]
            out.append((len(path) - 1, path[-1], calls, total, own))
            todo.extend(children.get(path, [])[::-1])
        return out

    def report(self) -> None:
        tag = f"[trace:{self.name}]"
        for depth, label, calls, total, own in self.tree():
            Logger.write(f"{tag} {'  ' * depth}{label}: {total * 1e3:.2f} ms"
                         f" (self {own * 1e3:.2f} ms, {calls} call"
                         f"{'s' if calls > 1 else ''})")
        for name, n in self.counters.items():
            Logger.write(f"{tag} {name}: {n}")
        if self.total:
            msg = f"{tag} total: {self.total * 1e3:.2f} ms"
            if self.pixels:
                msg += f" ({self.pixels / self.total / 1e6:.1f} Mpix/s)"
            Logger.write(msg)


_CURRENT: Trace | None = None
_IDLE = contextlib.nullcontext()


def current() -> Trace | None:
    """The innermost active tracing() scope, or None."""
    return _CURRENT


@contextlib.contextmanager
def tracing(name: str, pixels: int | None = None):
    """Collect the stage() marks and count() calls made inside the
    block."""
    global _CURRENT
    t, prev = Trace(name, pixels), _CURRENT
    _CURRENT = t
    try:
        with t:
            yield t
    finally:
        _CURRENT = prev


def stage(label: str):
    """Mark a library stage: a context manager that records into the
    active trace, if any; with none, a shared one that does nothing."""
    t = _CURRENT
    if t is None:
        return _IDLE
    return t.stage(label)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active trace's counter ``name``, if any."""
    t = _CURRENT
    if t is not None:
        t.counters[name] = t.counters.get(name, 0) + n


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace of the block: the host's operations, the
    stages of an active :func:`tracing` scope and, where there is a card,
    its kernels and copies, written as a Chrome trace to
    ``logdir``/trace.json.  Yields the profiler."""
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
