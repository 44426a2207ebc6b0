"""Each of the port's timed entry points enters each of its timer stages,
under the names the benchmark reads (benchmark/metrics/*: a per-layer
metric is the device time of its stages, and a stage renamed or dropped
reads as none). A recording `timer` is handed to one request of each
entry on the CPU (tests/torch_entries.py at the span tests' size: 2
shapes or micro-batches of 256 points, kNN k 10): batch_metrics with the
committed decoders, the e2e trainer's step with decoders, the
segmentation trainer's step and the closed SplineNet's fed step; and
each metric is held to the entries of the cells BENCHMARK.json says read
it, predict_segmentation among them."""
from __future__ import annotations

import ast
import contextlib
import json
import pathlib
import re

import pytest
import torch

import torch_entries as te
from parsenet_tpu_torch.eval import pipeline
from parsenet_tpu_torch.train import train_e2e, train_seg, train_spline

torch.set_num_threads(1)
ROOT = pathlib.Path(te.ROOT)
# entry -> the stages it enters, in order
STAGES = {"batch_metrics": pipeline.STAGES,
          "e2e_train_step": train_e2e.STAGES,
          "seg_train_step": train_seg.STAGES,
          "spline_train_step": train_spline.STAGES}


def recording_timer(entered: list):
    """A `timer` that appends each stage's name as it is entered."""
    @contextlib.contextmanager
    def timer(stage: str):
        entered.append(stage)
        yield
    return timer


@pytest.fixture(scope="module")
def entered():
    """entry -> the stage names one request of it entered (each entry run
    once for the module)."""
    cache = {}

    def get(entry: str) -> list:
        if entry not in cache:
            names = []
            te.request(entry, torch.device("cpu"), 256, 10,
                       timer=recording_timer(names))()
            cache[entry] = names
        return cache[entry]
    return get


@pytest.mark.parametrize("entry, stage", [
    pytest.param(e, s, id=f"{e}-{s}") for e, ss in STAGES.items()
    for s in ss])
def test_entry_enters_each_stage(entered, entry, stage):
    assert stage in entered(entry), (entry, stage, entered(entry))


@pytest.mark.parametrize("entry", list(STAGES))
def test_entry_enters_no_other_stage(entered, entry):
    assert set(entered(entry)) <= set(STAGES[entry]), (
        set(entered(entry)) - set(STAGES[entry]))


def _metric_stages(path: pathlib.Path) -> tuple:
    """The stage names a benchmark metric reads (Reading.per_unit's
    arguments)."""
    calls = re.findall(r"per_unit\(([^)]*)\)", path.read_text())
    return tuple(s for c in calls for s in ast.literal_eval(f"({c},)"))


def _metric_drivers(name: str) -> dict:
    """cell -> the driver (an entry of torch_entries) of each cell that
    BENCHMARK.json says reads the per-layer metric `name`."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (metric,) = (m for m in spec["per_layer"] if m["name"] == name)
    return {w: json.loads((ROOT / "benchmark" / "workloads" /
                           f"{w}.json").read_text())["driver"]
            for w in metric["workloads"]}


METRIC_FILES = sorted(p for p in (ROOT / "benchmark" / "metrics").glob(
    "*.py") if "per_unit(" in p.read_text())


@pytest.mark.parametrize("path", METRIC_FILES, ids=lambda p: p.stem)
def test_benchmark_reads_only_stages_the_port_enters(entered, path):
    """Each cell that reads the metric runs a driver whose entry enters
    every stage the metric reads: a stage renamed in one trainer is not
    hidden by another trainer that keeps the name."""
    stages = _metric_stages(path)
    drivers = _metric_drivers(path.stem)
    assert stages and drivers, (path.name, stages, drivers)
    for cell, driver in drivers.items():
        missing = set(stages) - set(entered(driver))
        assert not missing, (path.name, cell, driver, missing)
