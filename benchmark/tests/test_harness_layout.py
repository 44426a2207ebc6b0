"""BENCHMARK.json against the rules of its format, and every cell and
metric found from its files."""
from __future__ import annotations

import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return harness.load_spec()


def test_top_level_keys_and_command():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    for p in s["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51


def test_check_budget_holds_24_cells():
    # a full check: 2 + 14 x cells runs of run_seconds + 60 s, each cell
    # 2 x 90 s to compile, 1,200 s spare, within 43,200 s at 24 cells
    r = spec()["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    s = spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/configs/")
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = s["end_to_end"] + s["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in s["end_to_end"]} == {
        "shapes_per_s", "batch_ms_p90", "train_shapes_per_s", "setup_s"}


def test_every_cell_reports_what_its_metrics_move():
    s = spec()
    for w in s["workloads"]:
        cell = harness.Cell(s, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    layers = {}
    for m in s["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert w in {x["name"] for x in s["workloads"]}
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = harness.Cell(spec(), name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    driver = harness.load_module("drivers", cell.driver)
    assert hasattr(driver, "Driver")
    for key in ("points", "pool_shapes", "profiled_requests"):
        assert key in cell.mix


@pytest.mark.parametrize("name", [m["name"] for m in
                                  harness.load_spec()["per_layer"]])
def test_every_metric_has_a_reader(name):
    assert callable(harness.load_module("metrics", name).read)
