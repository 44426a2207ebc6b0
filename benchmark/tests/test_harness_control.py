"""The control and the planted faults on the card, at the cells' own sizes,
on three seeds: the reference one step below each configuration's
precision, put in the program's place, comes out not correct in every
cell, and so does each planted fault (benchmark/readings.py: half of each
training step's batch left out; a fault after the network in half of each
inference request's shapes), while the program comes out correct. A few
minutes on one card: `python -m pytest benchmark/tests/test_harness_control.py`
there. The readings the limits were set from (12 seeds a cell) are
benchmark/readings.py's (PERF.md)."""
from __future__ import annotations

import functools
import json

import pytest

from benchmark import harness
from benchmark.readings import readings

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEEDS = (2 ** 31 + 41, 2 ** 31 + 42, 2 ** 31 + 43)


def _fails(got: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in got.items())


@functools.lru_cache(maxsize=None)
def _readings(name: str, seed: int) -> tuple:
    import torch
    cell = harness.Cell(harness.load_spec(), name)
    got = readings(cell, torch.device("cuda", 0), seed, 3.0)
    harness.say(f"readings {name} {json.dumps(got)}")
    return cell, got


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cuda_device):
    for seed in SEEDS:
        cell, got = _readings(name, seed)
        assert not _fails(got["program"], cell.limits), got
        assert _fails(got["control"], cell.limits), got


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_are_not_correct(name, cuda_device):
    for seed in SEEDS:
        cell, got = _readings(name, seed)
        faults = [k for k in got if k not in ("seed", "program", "control")]
        assert faults, got
        for k in faults:
            assert _fails(got[k], cell.limits), (k, got)
