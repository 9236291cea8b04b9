"""Shared pieces of the benchmark's tests: tiny versions of the cells,
run on the CPU through the port's plain path, and the ``cuda`` marker.

Run them from the repository's root:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
import time

import pytest

from benchmark import harness

QUANT = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]
CELLS = tuple(c["name"] for c in harness.spec()["workloads"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")


def tiny(name: str):
    """(cell, configuration, traffic, BENCHMARK.json) of a cell cut to a
    size the CPU runs in a fraction of a second."""
    bench = harness.spec()
    config_name, traffic_name = name.split(".", 1)
    cell = {"name": name, "config": config_name, "traffic": traffic_name,
            "chips": 1}
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    if config["kind"] == "image":
        config.update(width=64, height=32)
        traffic.update(pool=8, batch=4, noise_every=4, profile_requests=3)
    else:
        config.update(width=64, height=48, frame_count=6)
        traffic.update(profile_requests=2)
    return cell, config, traffic, bench


def run_tiny(name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
             trace: bool = False, program=None, **overrides) -> dict:
    """One run of a tiny cell on the CPU; ``program`` (a function of the
    workload giving f(input) -> output) takes the port's place."""
    cell, config, traffic, bench = tiny(name)
    for key, value in overrides.items():
        (config if key in config else traffic)[key] = value
    return harness.run(cell, config, traffic, bench, seed, seconds, trace,
                       "cpu", time.perf_counter(), program=program,
                       log=sys.stderr)


@pytest.fixture
def cuda():
    """Skips the test where there is no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
