"""Tiny cells for the CPU tests: the cell of BENCHMARK.json with its mix
and configuration cut to sizes the CPU runs in seconds (one spline slot,
a few hundred points), in the program and the reference alike."""
from __future__ import annotations

import copy

from benchmark import harness

SIZES = {"e2e-protocol": dict(points=256, batch=2),
         "e2e-segment": dict(points=256, batch=2),
         "normals-train": dict(points=300, keep_points=200, batch=2, accum=2),
         "e2e-train": dict(points=400, keep_points=300, batch=1, accum=2)}


def tiny_cell(name: str, sizes=None):
    """The cell `name` at its SIZES (or `sizes`), with 6 pool shapes and
    the first window request checked."""
    cell = harness.Cell(harness.load_spec(), name)
    cell.mix = dict(cell.mix, pool_shapes=6, check_span=1,
                    check_requests=1,
                    **(sizes or SIZES.get(name, {})))
    cell.config = copy.deepcopy(cell.config)
    if "spline_slots" in cell.config:
        cell.config["spline_slots"]["slots"] = 1
    return cell


def one_slot(monkeypatch):
    """One spline slot a shape in the program's and the reference's
    inference pipelines."""
    import parsenet_tpu_torch.eval.pipeline as program
    from benchmark.reference.plain.eval import pipeline as reference
    monkeypatch.setattr(program, "EVAL_SPLINE_SLOTS", 1)
    monkeypatch.setattr(reference, "EVAL_SPLINE_SLOTS", 1)
