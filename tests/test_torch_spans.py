"""The port's spans (core.profiling.trace) on the CPU: each of the five
entry points opens one entry span around a request or a step, and every
sync.*, ms.* and feed.* span of it lies inside; one ms.attempt span a
bandwidth the mean-shift guard tries; and the benchmark's readers of the
spans (benchmark/spans.py) on hand-built readings."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_entries as te
from benchmark import harness
from benchmark.trace import Reading
from parsenet_tpu_torch.ops import mean_shift

CPU = torch.device("cpu")


@pytest.mark.parametrize("entry", te.ENTRIES)
def test_spans_lie_inside_their_entry_span(entry):
    spans = te.profiled(te.request(entry, CPU, 256, 10))
    (outer,) = [(a, b) for n, a, b in spans if n == f"entry.{entry}"]
    inner = [(n, a, b) for n, a, b in spans
             if n.startswith(("sync.", "ms.", "feed."))]
    names = {n for n, _, _ in inner}
    if entry == "spline_train_step":
        # its syncs are the copies to the card (sync.h2d_input), which
        # the CPU does not make
        assert names == {"feed.next"}, names
    else:
        assert any(n.startswith("sync.") for n in names), names
    if entry not in ("seg_train_step", "spline_train_step"):
        assert "ms.attempt" in names and "ms.subset" in names
    for n, a, b in inner + [s for s in spans if s[0].startswith("entry.")]:
        assert outer[0] <= a <= b <= outer[1], (n, a, b, outer)


@pytest.mark.parametrize("differentiable", [False, True])
def test_one_attempt_span_a_bandwidth_tried(monkeypatch, differentiable):
    """max_clusters forced to 1: the guard escalates; its attempts, one NMS
    each (and one more for the training re-run), are the ms.attempt spans."""
    rng = np.random.RandomState(2)
    X = torch.nn.functional.normalize(
        torch.as_tensor(rng.randn(300, 3), dtype=torch.float32), dim=1)
    calls = []
    nms = mean_shift.nms
    monkeypatch.setattr(mean_shift, "nms",
                        lambda *a: calls.append(1) or nms(*a))

    def run():
        mean_shift.guard_mean_shift(
            X.requires_grad_(differentiable), 0.015, num_samples=300,
            iterations=3, max_clusters=1, max_doublings=3,
            differentiable=differentiable)
    spans = [n for n, _, _ in te.profiled(run)]
    attempts = len(calls) - differentiable
    assert 1 < attempts <= 4
    assert spans.count("ms.attempt") == attempts
    assert spans.count("ms.rerun") == int(differentiable)
    assert spans.count("ms.subset") == 1
    assert spans.count("sync.ms_clusters") == len(calls)


def _reading(kind: str) -> Reading:
    """An inference stretch of 4 shapes (one request: batch_metrics around
    predict_segmentation) or a training one of 2 steps of 5 shapes, spans
    in microseconds."""
    r = Reading(kind, {"embed_losses": 30.0}, 20, 3, 1.0, {}, None)
    if kind == "infer":
        r.capture_units = 4
        r.ranges = ([("entry.batch_metrics", 0.0, 1000.0),
                     ("entry.predict_segmentation", 10.0, 500.0),
                     ("sync.ms_clusters", 100.0, 150.0),
                     ("fits_sampling", 550.0, 800.0),
                     ("sync.fits_solve", 600.0, 700.0)]
                    + [("ms.attempt", 20.0 + i, 21.0 + i) for i in range(6)])
    else:
        r.capture_units = 10
        r.ranges = ([("entry.e2e_train_step", 0.0, 1000.0),
                     ("entry.e2e_train_step", 1200.0, 2000.0),
                     ("sync.ms_clusters", 100.0, 200.0),
                     ("sync.isin_values", 1300.0, 1400.0),
                     ("sync.fits_solve", 1500.0, 1550.0)]
                    + [("ms.attempt", 5.0 + i, 6.0 + i) for i in range(15)])
    return r


READINGS = {
    "host_syncs.infer": 2 / 4,
    "sync_wait_ms.infer": 0.150 / 4,
    "enqueue_ms.infer": (1.0 - 0.150) / 4,
    "ms_attempts.infer": 6 / 4,
    "host_syncs.train": 3 / 2,
    "sync_wait_ms.train": 0.250 / 2,
    "enqueue_ms.train": (1.8 - 0.250) / 2,
    "ms_attempts.train": 15 / 10,
    "embed_losses_ms.train": 30.0 / 3,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_span_readers(name):
    read = harness.load_module("metrics", name).read
    kind = name.split(".")[1]
    assert read(_reading(kind)) == pytest.approx(READINGS[name])
    bare = Reading(kind, {}, 20, 3, 1.0, {}, None)
    bare.capture_units = 4
    assert read(bare) is None
