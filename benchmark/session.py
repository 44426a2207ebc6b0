"""One run of a cell, apart from the command line: set-up, the window, the
readings of a traced run and the check. benchmark/run.py prints what this
returns; the tests drive it on the CPU at tiny sizes."""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import torch

from . import harness
from .loops import StageClock, closed_loop, profiled_stretch
from .trace import Reading, percentile


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def end_to_end(cell, win, setup_s: float) -> dict:
    values = {"setup_s": setup_s,
              "shapes_per_s": win.units / win.seconds,
              "train_shapes_per_s": win.units / win.seconds,
              "batch_ms_p90": 1e3 * percentile(win.latencies_s, 90)}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, reading: Reading) -> dict:
    """Each of the cell's per-layer metrics that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = harness.load_module("metrics", m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell, dev, seed: int, seconds: float, trace: bool = False,
             tamper: Optional[Callable] = None) -> dict:
    """One run -> {"result": the JSON object without the device's name,
    "stage_ms", "window"}. tamper(driver), where given, changes the
    driver's timed path before its first request (the tests' planted
    faults)."""
    cuda = dev.type == "cuda"
    if trace and not cuda:
        raise ValueError("run_cell: a traced run reads the card's events and "
                         "profiler trace; there is no CPU version of them")
    seeds = harness.seeds(seed)
    t0 = time.perf_counter()
    drv = harness.load_module("drivers", cell.driver).Driver(cell, dev)
    drv.start(seeds)
    if tamper is not None:
        tamper(drv)
    drv.warm()
    _sync(dev)
    setup_s = time.perf_counter() - t0

    clock = None
    if trace:
        clock = StageClock()
        drv.timer = clock
    win = closed_loop(drv.enqueue, drv.fetch, drv.units_of, seconds,
                      drv.next_index, cuda=cuda)
    stage_ms, capture = {}, None
    if trace:
        stage_ms = clock.total_ms()
        capture = profiled_stretch(drv.enqueue, drv.fetch, drv.units_of,
                                   win.next_index,
                                   int(cell.mix["profiled_requests"]))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    harness.say(f"window {win.seconds:.3f} s, {win.requests} requests, "
                f"{win.units} shapes, {drv.pool.distinct_served()} distinct "
                f"shapes of a pool of {drv.pool.size}, {drv.failed} failed")

    prog = drv.program_outputs()
    drv.release()
    t_ref = time.perf_counter()
    readings = drv.compare(prog, drv.reference_outputs(prog))
    harness.say(f"reference {time.perf_counter() - t_ref:.1f} s")
    check = {k: {"value": readings.get(k, math.inf), "limit": lim}
             for k, lim in cell.limits.items()}

    device = {"platform": "gpu", "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in check.values()),
              "attempted": win.requests, "failed": drv.failed}
    if trace:
        reading = Reading(drv.kind, stage_ms, win.units, win.requests,
                          win.seconds, drv.unit_counts(), capture)
        result["metrics"] = per_layer(cell, reading)
        device.update(reading.device())
        result["device"] = device
        bd = reading.breakdown()
        if bd is not None:
            result["breakdown"] = bd
    else:
        result["metrics"] = end_to_end(cell, win, setup_s)
        result["device"] = device
    result["check"] = check
    return {"result": result, "stage_ms": stage_ms, "window": win}
