"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, and every configuration, traffic mix, entry point, loop and metric found
by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness, workload

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = harness.spec()


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=[e["name"] for _, e in _names()])
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    extra = set(entry) - keys
    assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer")
                     else set())
    assert keys <= set(entry)
    for text in ("why", "layer"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200
            assert "\n" not in entry[text] and "\t" not in entry[text]
    if group in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "workloads":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] == 1
        assert len(entry["why"]) <= 200
    if group == "configs":
        assert all(NAME.match(k) for k in entry["reduced"])
        assert 1 <= len(entry["source"]) <= 200


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=[c["name"] for c in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    assert config["name"] == cell["config"]
    assert issubclass(workload.load("entries", traffic["entry"]).Entry,
                      workload.Workload)
    assert callable(workload.load("loops", traffic["loop"]).run)
    names = {c["name"]: c for c in BENCH["configs"]}
    assert names[cell["config"]]["file"] == \
        f"benchmark/configs/{cell['config']}.json"
    e2e = [m["name"] for m in harness.metrics_for(BENCH["end_to_end"],
                                                  cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(BENCH["per_layer"], cell["name"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=[m["name"] for m in BENCH["end_to_end"]])
def test_end_to_end_reader_found_by_name(metric):
    assert callable(harness.reader(metric["name"]))


def test_end_to_end_readers_take_the_whole_window():
    """A rate over every request and the window's seconds; a tail over
    every request, by nearest rank."""
    class Wl:
        direction, pixels = "encode", 2_000_000

    times = [0.001 * (i + 1) for i in range(40)]  # 1 .. 40 ms
    run = harness.Run(Wl(), 9.5, times, 2.0)
    assert harness.reader("encode_mpix_s")(run) == pytest.approx(40.0)
    assert harness.reader("encode_p95_ms")(run) == pytest.approx(38.0)
    assert harness.reader("setup_s")(run) == 9.5
    assert harness.reader("decode_mpix_s")(run) is None
    assert harness.reader("p95_ms.decode")(run) is None
    Wl.direction = "decode"
    assert harness.reader("p95_ms.decode")(run) == pytest.approx(38.0)
    assert harness.reader("encode_p95_ms")(run) is None


def test_missing_files_are_refused():
    with pytest.raises(ValueError):
        workload.load("entries", "no_such_entry")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric["name"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_configs_state_their_cuts():
    for entry in BENCH["configs"]:
        config = harness.load_json("configs", entry["name"])
        assert config["source"] == entry["source"]
        for key in entry["reduced"]:
            assert f"source_{key}" in config
        assert "assumed" in config and "guarantees" in config


def test_roofline_metrics_are_named_for_it():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
