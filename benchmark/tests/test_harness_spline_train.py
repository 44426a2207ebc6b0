"""A CPU dry run of closed-spline-train at tiny sizes through run_cell:
the closed SplineNet at its published widths, 4 patches a step of 192 or
256 points, the trainer's fed step against the reference; a state left
unchanged and half of each step's batch left out make `correct` false."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.session import run_cell

CPU = torch.device("cpu")
CELL = "closed-spline-train"
TINY = dict(points=256, batch=4, point_buckets=[128, 192], pool_shapes=12)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell():
    cell = harness.Cell(harness.load_spec(), CELL)
    cell.mix = dict(cell.mix, **TINY)
    return cell


def test_dry_run():
    cell = tiny_cell()
    res = run_cell(cell, CPU, 2 ** 31 + 21, 1.0)["result"]
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_shapes_per_s", "setup_s"}
    assert set(res["check"]) == {"first_loss_gap", "grad_gap",
                                 "median_change_gap", "change_gap"}
    assert res["device"]["memory_peak_bytes"] == 0
    with pytest.raises(ValueError, match="card"):
        run_cell(cell, CPU, 2 ** 31 + 22, 1.0, trace=True)


def _state_unchanged(drv):
    drv.optimizer.step = lambda *a, **k: None


def _half_batch(drv):
    """Each step's loss and gradient the mean over half of its patches:
    the other half replaced by copies of it, on the trainer's own feed."""
    from parsenet_tpu_torch.train.train_spline import make_fed_step
    step = drv.train_step

    def half(points, cps, scales, *rest):
        keep = np.arange(points.shape[0]) % (points.shape[0] // 2)
        return step(points[keep], cps[keep], scales[keep], *rest)
    drv.step_fn = make_fed_step(half, drv.feed, drv.host_rng, drv.buckets,
                                drv.dev, drawn=drv.points)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_planted_fault_is_not_correct(fault):
    res = run_cell(tiny_cell(), CPU, 2 ** 31 + 23, 1.0,
                   tamper=fault)["result"]
    assert not res["correct"], res["check"]
    assert any(not np.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in res["check"].values())


def test_flops_count_the_buckets_drawn():
    """unit_counts: the mean over the window's steps of a patch's FLOPs
    at the point count each step drew."""
    from benchmark.counts import spline
    drv = harness.load_module("drivers", "spline_train_step").Driver(
        tiny_cell(), CPU)
    drv.points = [128] * 3 + [192, 192, 128] + [999] * 9
    got = drv.unit_counts()["flops_per_shape"]
    want = (2 * spline.spline_train_flops(192, True)
            + spline.spline_train_flops(128, True)) / 3
    assert got == pytest.approx(want)
