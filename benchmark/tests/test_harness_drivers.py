"""A CPU dry run of each cell at tiny sizes: set-up, the window and the
check run through the cell's driver, the result holds the cell's
end-to-end metrics and no device reading; a traced run needs the card.
Faults planted in the timed path make `correct` false."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import faults
from benchmark.session import run_cell
from benchmark.tests.tiny import one_slot, tiny_cell

CPU = torch.device("cpu")
CELLS = ["e2e-protocol", "e2e-segment", "normals-train", "e2e-train"]


@pytest.fixture(autouse=True)
def small(monkeypatch):
    one_slot(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_dry_run(name):
    cell = tiny_cell(name)
    res = run_cell(cell, CPU, 2 ** 31 + 21, 1.0)["result"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["device"]["memory_peak_bytes"] == 0
    assert "busy_s" not in res["device"] and "breakdown" not in res
    assert list(res)[-1] == "check"
    with pytest.raises(ValueError, match="card"):
        run_cell(cell, CPU, 2 ** 31 + 22, 1.0, trace=True)


def _answer_altered(drv):
    call = drv.call

    def altered(i, batch):
        vals, extras = call(i, batch)
        col = drv.columns.index("seg_iou")
        return vals.index_add(1, torch.tensor([col]), torch.full(
            (vals.shape[0], 1), 0.05)), extras
    drv.call = altered


def _half_request(drv):
    """Half of each request's shapes left out, their answers those of the
    first half."""
    call = drv.call

    def half(i, batch):
        b = batch[0].shape[0] // 2
        vals, extras = call(i, tuple(a[:b] for a in batch))
        return torch.cat([vals, vals]), extras
    drv.call = half


def _state_unchanged(drv):
    drv.optimizer.step = lambda *a, **k: None


def _half_step(drv):
    """Each step's loss and gradient the mean over half of its shapes: the
    other half replaced by copies of it (within each micro-batch, or of
    the first micro-batches where a micro-batch holds one shape)."""
    step = drv.step_fn
    a, b = drv.accum, drv.batch
    if b > 1:
        keep = [m * b + j % (b // 2) for m in range(a) for j in range(b)]
    else:
        keep = [m % ((a + 1) // 2) for m in range(a)]

    def half(x, labels, prim):
        return step(x[keep], labels[keep], prim[keep])
    drv.step_fn = half


FAULTS = [("e2e-protocol", _answer_altered), ("e2e-protocol", _half_request),
          ("e2e-segment", _answer_altered), ("e2e-segment", _half_request),
          ("normals-train", _state_unchanged), ("normals-train", _half_step),
          ("e2e-train", _state_unchanged), ("e2e-train", _half_step)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_planted_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    res = run_cell(cell, CPU, 2 ** 31 + 23, 1.0, tamper=fault)["result"]
    assert not res["correct"], res["check"]
    assert any(not np.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in res["check"].values())


# shapes need more points than SIZES gives them to hold
# clusters that the SIOU matching scores above nought
FAULT_SIZES = {"e2e-segment": dict(points=1000, batch=2),
               "e2e-protocol": dict(points=1000, batch=2)}
AFTER = [(name, fault) for name in ("e2e-protocol", "e2e-segment")
         for fault in faults.AFTER_NETWORK[tiny_cell(name).driver]]


@pytest.mark.parametrize("name,fault", AFTER,
                         ids=[f"{n}-{f.__name__}" for n, f in AFTER])
def test_fault_after_network_is_not_correct(name, fault):
    """A fault after the network in half of each request's shapes: the
    network's outputs are the reference's, and the per-shape numbers
    catch it."""
    cell = tiny_cell(name, FAULT_SIZES.get(name))
    with fault(int(cell.mix["batch"])):
        res = run_cell(cell, CPU, 2 ** 31 + 25, 1.0)["result"]
    assert res["check"]["net_gap"]["value"] <= res["check"]["net_gap"][
        "limit"]
    assert not res["correct"], res["check"]
