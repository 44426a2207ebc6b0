"""The 4-card cell's driver (drivers/seg_train_step_dp.py) at 2 gloo ranks
on the CPU at tiny sizes: set-up, the window and the check run through
run_cell to a correct result, the ranks follow rank 0 to its last step and
are gone after release; with the gradient all-reduce skipped on every rank
the check refuses the run. The three readers of the cell read None where
there is nothing to read and never 0; the all-reduced bytes are the
model's parameters, a normaliser a micro-batch and the step's metrics."""
from __future__ import annotations

import pytest
import torch

from benchmark import counts, harness
from benchmark.counts import dp
from benchmark.session import run_cell
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import Reading

CPU = torch.device("cpu")
NAME = "normals-train-4card"
READERS = ("collective_ms.train", "collective_roofline.train",
           "mfu_cards.train")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    cell = tiny_cell(NAME, dict(points=300, keep_points=200, batch=4,
                                accum=2, ranks=2))
    cell.config["network"] = dict(cell.config["network"], k=16)
    return cell


def _run(monkeypatch, skip_all_reduce: bool, seed: int) -> dict:
    drv_mod = harness.load_module("drivers", "seg_train_step_dp")
    monkeypatch.setattr(drv_mod.Driver, "skip_all_reduce", skip_all_reduce)
    procs, drivers = [], []
    start = drv_mod.Driver.start

    def start_and_keep(self, seeds):
        start(self, seeds)
        procs.extend(self.ranks.procs)
        drivers.append(self)
    monkeypatch.setattr(drv_mod.Driver, "start", start_and_keep)
    res = run_cell(_cell(), CPU, seed, 1.0)["result"]
    assert procs and not any(p.is_alive() for p in procs)
    assert not torch.distributed.is_initialized()
    return res, drivers[0]


def test_two_ranks_run_the_cell_to_a_correct_result(monkeypatch):
    res, drv = _run(monkeypatch, False, 2 ** 31 + 51)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["check"]) == {"first_loss_gap", "loss_gap", "grad_gap",
                                 "change_gap", "rank_gap"}
    assert res["check"]["rank_gap"]["value"] == 0.0
    assert set(res["metrics"]) == {"train_shapes_per_s", "setup_s"}
    # after release, from the model the ranks ran: its flattened
    # gradients, a normaliser a micro-batch and the step's 3 metrics
    from benchmark.reference.train import network
    n = sum(p.numel() for p in network(_cell().config, CPU,
                                       init_seed=0).parameters())
    assert drv.unit_counts()["collective_bytes"] == 4 * (n + 2 + 3)
    assert drv.unit_counts()["chips"] == 2


def test_skipped_all_reduce_is_refused(monkeypatch):
    res, _ = _run(monkeypatch, True, 2 ** 31 + 52)
    assert not res["correct"], res["check"]
    c = res["check"]
    assert (c["grad_gap"]["value"] > c["grad_gap"]["limit"]
            and c["rank_gap"]["value"] > c["rank_gap"]["limit"]), c


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


class _Event:
    def __init__(self, name, a, b, cuda):
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = not cuda
        self.time_range = type("R", (), {"start": a, "end": b})()


def _reading(kernels, steps, counts_):
    ev = [_Event("entry.seg_train_step", 1000.0 * i, 1000.0 * i + 900, False)
          for i in range(steps)]
    ev += [_Event(n, a, b, True) for n, a, b in kernels]
    cap = {"prof": _Prof(ev), "wall_s": 0.002 * max(steps, 1),
           "units": 24 * steps}
    return Reading("train", {}, 24 * steps, steps, 1.0, counts_, cap)


def test_readers_read_none_where_nothing_is_there_and_never_0():
    full = {"flops_per_shape": 1e12, "chips": 4,
            "collective_bytes": dp.seg_step_allreduce_bytes(1247882, 3)}
    kernels = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.0, 150.0),
               ("sgemm", 200.0, 500.0),
               ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 1000.0, 1050.0)]
    empty = [_reading([], 0, {"flops_per_shape": 1.0}),
             _reading([("sgemm", 0.0, 10.0)], 2, full),
             Reading("train", {}, 0, 0, 0.0, {"flops_per_shape": 1.0},
                     None)]
    for name in READERS:
        read = harness.load_module("metrics", name).read
        for r in empty[:1] + empty[2:]:
            assert read(r) is None, name
        if name != "mfu_cards.train":
            assert read(empty[1]) is None, name
    r = _reading(kernels, 2, full)
    got = {n: harness.load_module("metrics", n).read(r) for n in READERS}
    assert got["collective_ms.train"] == pytest.approx(0.1)   # 200 us / 2
    least_ms = 1e3 * dp.allreduce_least_seconds(
        full["collective_bytes"], 4)
    assert got["collective_roofline.train"] == pytest.approx(
        100.0 * least_ms / 0.1)
    assert 0 < got["collective_roofline.train"] <= 100
    assert got["mfu_cards.train"] == pytest.approx(
        100.0 * 1e12 * 48 / 1.0 / counts.PEAK_FLOPS / 4)


def test_all_reduced_bytes_are_the_models_parameters():
    from benchmark.reference.train import network
    cfg = harness.load_json("configs", "parsenet_normals_dp4")
    model = network(cfg, CPU, init_seed=0)
    n = sum(p.numel() for p in model.parameters())
    assert n == 1247882
    assert dp.seg_step_allreduce_bytes(n, 3) == 4 * (n + 3 + 3)
    # a ring all-reduce over 4 ranks moves 1.5 x the bytes a rank, at
    # 450 GB/s a direction
    assert dp.NVLINK_BYTES == 450e9
    assert dp.allreduce_least_seconds(450e9, 4) == pytest.approx(1.5)
