"""The harness on the card, at tiny sizes: each cell's run comes out
correct, traced and not, and its traced run reads the device.  They skip
where there is no card:

    python -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import time

import pytest

from benchmark import harness

from conftest import CELLS, tiny


def _run(name: str, trace: bool) -> dict:
    cell, config, traffic, bench = tiny(name)
    return harness.run(cell, config, traffic, bench, 2 ** 32 + 5, 0.5,
                       trace, "cuda:0", time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda, name):
    result = _run(name, False)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_reads_the_device(cuda, name):
    result = _run(name, True)
    assert result["correct"] is True
    device = result["device"]
    assert 0 < device["busy_s"] <= device["window_s"]
    roofline = next(v["value"] for k, v in result["metrics"].items()
                    if k.endswith("_roofline"))
    assert 0 < roofline <= 100
    assert result["breakdown"]["device_ops"]
