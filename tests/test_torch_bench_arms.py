"""The port's bench (parsenet_tpu_torch.cli.bench.run) on the CPU at
reduced scale for each BENCH_ABLATE arm: 256 points, batch 2, 1 timed
batch after the 2 warm-up ones, the shipped weights, 1 spline slot a shape
instead of 12 (the decoders' cost on the CPU is a fixed 1,800 rows a slot
whatever the point count). The arms that keep the full path's draws
(residual, coverage, siou) are here, beside the full run they are held
to; the others are in tests/test_torch_bench_arms_stub.py. Each record is well formed with
floors_applied false, and the arm's sections report what bench.py's arms
report: 0 for what it skips, 1 for the SIOU it skips; where the arm draws
what the full path draws (siou, coverage, residual), the rest equal the
full run's.
"""
import os

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.cli import bench
from parsenet_tpu_torch.eval import pipeline as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = {"BENCH_POINTS": "256", "BENCH_BATCH": "2", "BENCH_ITERS": "1"}
QUALITY = ("residual", "seg_iou", "p_cov", "sk_2")
torch.set_num_threads(1)
# the arm -> metrics it zeroes, metrics it sets to 1, metrics equal to the
# full run's
ARMS = {
    "residual": (("residual",), (), ("seg_iou", "p_cov", "sk_2")),
    "coverage": (("p_cov", "sk_2"), (), ("seg_iou", "residual")),
    "siou": ((), ("seg_iou",), ("residual", "p_cov", "sk_2")),
}


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.chdir(REPO)
    mp.setattr(tp, "EVAL_SPLINE_SLOTS", 1)
    cache = {}

    def run(arm):
        if arm not in cache:
            env = dict(REDUCED, BENCH_ABLATE=arm)
            cache[arm] = bench.run(bench.settings(env), "cpu")
            assert cache[arm]["detail"]["ablate"] == arm
        return cache[arm]
    yield run
    mp.undo()


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_reduced_run(runs, arm):
    check_arm(runs(arm), runs(""), *ARMS[arm])


def check_arm(rec, full, zero, one, same):
    d = rec["detail"]
    assert rec["metric"] == bench.METRIC and rec["value"] > 0
    assert d["floors_applied"] is False and d["quality_ok"] is True
    for k in QUALITY:
        assert np.isfinite(d[k]), k
        if k in zero:
            assert d[k] == 0.0, k
        elif k in one:
            assert d[k] == 1.0, k
        elif k in same:
            assert d[k] == full["detail"][k], (k, d[k], full["detail"][k])
        else:
            assert d[k] >= 0.0, k
