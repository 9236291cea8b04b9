"""One run of one cell: set-up, a measured window, the check, one line.

``run.py`` calls :func:`main`.  A run

  1. reads its cell from BENCHMARK.json, the cell's configuration from
     ``configs/<config>.json`` and its traffic from
     ``traffic/<traffic>.json``, which names the entry point
     (``entries/<entry>.py``) and the loop (``loops/<loop>.py``);
  2. makes the inputs on the device from the seed, warms the program up
     on the cell's own shapes, and counts all of that, from the process's
     start, as ``setup_s`` (less what the reference spent making inputs);
  3. runs the loop for ``--seconds``;
  4. reports the cell's end-to-end metrics or, with ``--trace 1``, its
     per-layer ones: each read from the window by ``metrics/<name>.py``;
     a traced run records the program's spans over the whole window and
     profiles the device over a stretch of it;
  5. reads the device's peak memory, frees the window's outputs but the
     kept ones, checks those against the reference, prints each number
     compared beside its limit on standard error, then the result line.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

from . import tracing, workload

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "imageencoder_tpu")


def spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def metrics_for(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The metric's reader, ``metrics/<name>.py``'s read()."""
    return workload.load("metrics", name).read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (a name blocked with None is not loaded)."""
    return sorted(name for name, mod in sys.modules.items()
                  if mod is not None and name.split(".")[0] in FORBIDDEN)


class Run:
    """What a run gives the metric readers: the window's requests, and in
    a traced run the program's spans and the profiled stretch."""

    def __init__(self, wl, setup_s: float, times: list, window_s: float,
                 spans=None, profile=None, profiled: int = 0,
                 least_s: float = 0.0):
        self.workload, self.setup_s = wl, setup_s
        self.times, self.window_s = times, window_s
        self.spans, self.profile = spans, profile
        self.profiled, self.least_s = profiled, least_s

    @property
    def direction(self) -> str:
        return self.workload.direction

    def span_ms(self, *labels) -> float | None:
        """Host milliseconds a request in the program's spans of these
        labels, or None where the window had none."""
        hits = [r for r in self.spans.records if r[0] in labels]
        if not hits or not self.times:
            return None
        return sum(e - s for _, s, e in hits) / len(self.times) * 1e3


class Quiet:
    """A loop's probe that does nothing."""

    def before(self, elapsed: float) -> None:
        pass

    def after(self, key, out) -> None:
        pass

    def close(self) -> None:
        pass


class Profiling(Quiet):
    """A loop's probe that profiles ``n`` requests from ``at`` seconds
    in, and sums their least device time."""

    def __init__(self, wl, at: float, n: int):
        self.wl, self.at, self.n = wl, at, n
        self.prof = self.mark = None
        self.profiled, self.least = 0, 0.0

    def before(self, elapsed):
        if self.prof is None and elapsed >= self.at:
            self.prof, self.mark = _start_profile()

    def after(self, key, out):
        if self.mark is not None:
            self.profiled += 1
            self.least += self.wl.least(key, out)["least_s"]
            if self.profiled == self.n:
                self.close()

    def close(self):
        if self.mark is not None:
            _stop_profile(self.prof, self.mark)
            self.mark = None

    @property
    def least_s(self) -> float:
        """The mean least device seconds of a profiled request."""
        return self.least / max(self.profiled, 1)


def _start_profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    mark = torch.profiler.record_function(tracing.STRETCH)
    mark.__enter__()
    return prof, mark


def _stop_profile(prof, mark) -> None:
    mark.__exit__(None, None, None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


def extra_profile(wl, n: int) -> Profiling:
    """A profile of ``n`` more requests, after the window (where the
    window's came back without device records)."""
    probe = Profiling(wl, 0.0, n)
    for _ in range(n):
        probe.before(0.0)
        key, inp = wl.draw()
        probe.after(key, wl.call(inp))
    probe.close()
    return probe


def read_profile(probe: Profiling, log):
    """The profiled stretch, profiled again after the window where the
    profiler dropped its device records (now and then it does)."""
    profile = tracing.read_profile(probe.prof) if probe.prof else None
    for _ in range(2):
        if profile is not None and profile.ops and \
                profile.kernels() >= profile.launches:
            break
        n = max(probe.profiled, 8)
        print(f"profile: device records missing; profiling {n} more "
              f"requests", file=log)
        with tracing.program_spans(tracing.Spans()):
            probe = extra_profile(probe.wl, n)
        profile = tracing.read_profile(probe.prof)
    return profile, probe


def run(cell: dict, config: dict, traffic: dict, bench: dict, seed: int,
        seconds: float, trace: bool, device, t_start: float,
        program=None, log=sys.stderr) -> dict:
    """One run; returns the result (the keys of the result line).
    ``program``, where given, is a function of the workload that gives
    f(input) -> output in the port's place (the tests' faults, the
    control)."""
    dev = torch.device(device)
    wl = workload.make(config, traffic, seed, dev)
    loop = workload.load("loops", traffic["loop"])
    wl.program = program(wl) if program else wl.port_program()
    t_context = time.perf_counter()
    torch.zeros(1, device=dev)  # the CUDA context
    t_inputs = time.perf_counter()
    wl.make_inputs()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_warm = time.perf_counter()
    for inp in random_warm(wl, int(traffic["warm_requests"])):
        wl.call(inp)
    spans = tracing.Spans()
    if trace:
        # The profiler's first session initializes CUPTI: in the set-up.
        prof, mark = _start_profile()
        wl.call(random_warm(wl, 1)[0])
        _stop_profile(prof, mark)
    t_window = time.perf_counter()
    setup_s = t_window - t_start - wl.reference_s
    print(f"set-up: {setup_s:.6f} s: imports {t_context - t_start:.6f}, "
          f"context {t_inputs - t_context:.6f}, inputs "
          f"{t_warm - t_inputs - wl.reference_s:.6f} (and the reference's "
          f"{wl.reference_s:.6f}, not counted), warm-up "
          f"{t_window - t_warm:.6f}", file=log)
    if trace:
        probe = Profiling(wl, float(traffic["profile_at"]) * seconds,
                          int(traffic["profile_requests"]))

        def traced_call(inp):
            with spans.span("request"):
                return wl.call(inp)
        with tracing.program_spans(spans):
            times, window_s = loop.run(wl, traced_call, seconds, probe)
    else:
        times, window_s = loop.run(wl, wl.call, seconds, Quiet())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    report_window(times, window_s, log)

    result = {"correct": False, "attempted": len(times), "failed": 0,
              "metrics": {}, "device": device_info(dev, peak)}
    if trace:
        profile, probe = read_profile(probe, log)
        done = Run(wl, setup_s, times, window_s, spans, profile,
                   probe.profiled, probe.least_s)
        for m in metrics_for(bench["per_layer"], cell["name"]):
            value = reader(m["name"])(done)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": profile.top_ops(),
                               "idle_gaps": profile.idle_by_span()}
        result["device"].update(busy_s=profile.busy_s(),
                                window_s=profile.window_s)
        print(f"profile: {profile.kernels()} kernels "
              f"({profile.launches} launch calls seen), {probe.profiled} "
              f"requests over {profile.window_s:.6f} s", file=log)
    else:
        done = Run(wl, setup_s, times, window_s)
        for m in metrics_for(bench["end_to_end"], cell["name"]):
            value = reader(m["name"])(done)
            if value is None:
                raise ValueError(f"{cell['name']} lists {m['name']}, and "
                                 f"its reader found nothing to read")
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}

    # The check, once the window has closed and the peak is read.
    spans.records.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    mismatched, bad = wl.check()
    checked = len(wl.kept)
    result["failed"] = bad
    result["correct"] = checked > 0 and mismatched == 0
    result["checks"] = {wl.check_name: {"value": mismatched, "limit": 0},
                        "checked_requests": {"value": checked,
                                             "limit": 1}}
    print(f"checked {checked} requests of {len(times)} against the "
          f"reference in {time.perf_counter() - t_check:.3f} s; {bad} "
          f"differ", file=log)
    print(f"check {wl.check_name}: {mismatched} (limit 0)", file=log)
    print(f"check checked_requests: {checked} (limit: at least 1)",
          file=log)
    return result


def report_window(times: list, window_s: float, log) -> None:
    """The window's requests a second and its request times, on standard
    error: what a reader of a noisy run looks at first."""
    per_s, t = [0] * (int(window_s) + 1), 0.0
    for dt in times:
        t += dt
        per_s[min(int(t), len(per_s) - 1)] += 1
    ms = sorted(1e3 * dt for dt in times)
    n = len(ms)
    print(f"window: {n} requests in {window_s:.6f} s, a second "
          f"{per_s}", file=log)
    if n:
        print(f"window: a request's host ms: median {ms[n // 2]:.4f}, p90 "
              f"{ms[int(0.9 * n)]:.4f}, max {ms[-1]:.4f}", file=log)


def random_warm(wl, n: int) -> list:
    """Inputs for the warm-up: the cell's own shapes, drawn apart from
    the window's order."""
    import random

    order, wl.order = wl.order, random.Random(f"warm:{wl.seed}")
    try:
        return [wl.draw()[1] for _ in range(n)]
    finally:
        wl.order = order


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def main(args, t_start: float) -> int:
    bench = spec()
    cell = cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    config = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    result = run(cell, config, traffic, bench, args.seed, args.seconds,
                 bool(args.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)  # "checks" is its last key
    return 0
