"""The measured window, the stage clock and the profiler capture.

A closed loop with one client: request after request (a batch of shapes or
an optimizer step), each request's results fetched one request behind, as
the port's cli.bench fetches them. A request's latency runs from the host's
first enqueue of it to the device finishing its results (a CUDA event after
the request, read against an event taken at the window's start).

`StageClock` is what the traced run hands the program as its `timer`: for
each stage the program marks it records a CUDA event pair, as the port's
core.profiling.StageTimer does (device time on the stream from the stage's
first enqueued work to its last, host gaps included), and opens a
torch.profiler.record_function range of the stage's name, so the profiler's
idle gaps can be labelled by the stage the host was in.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


class StageClock:
    """Device time per stage from CUDA event pairs, and a profiler range a
    stage (the program's `timer` protocol: `with clock(stage): ...`)."""

    def __init__(self):
        self.events: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(stage):
            start.record()
            try:
                yield
            finally:
                end.record()
                self.events.setdefault(stage, []).append((start, end))

    def total_ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.events.items()}


class NoClock:
    """The program's timer protocol doing nothing (the untraced run)."""

    @contextlib.contextmanager
    def __call__(self, stage: str):
        yield


class Window:
    """What a window measured: requests and units (shapes) completed, the
    seconds from its start to its last fetch, each request's latency and
    the index of the next request."""

    def __init__(self):
        self.requests = 0
        self.units = 0
        self.seconds = 0.0
        self.latencies_s: list = []
        self.next_index = 0


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def closed_loop(enqueue: Callable, fetch: Callable, units_of: Callable,
                seconds: float, start_index: int = 0,
                cuda: bool = True) -> Window:
    """Run requests start_index, start_index + 1, ... until `seconds` have
    passed, then finish the last. enqueue(i) queues request i and returns
    its handle; fetch(handle) brings its results to the host; units_of(
    handle) counts its shapes. cuda=False (the CPU rehearsals of the
    tests): latencies end at the fetch."""
    win = Window()
    _sync(cuda)
    e0 = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        e0.record()
    _sync(cuda)
    t0 = time.perf_counter()
    pending = []
    i = start_index

    def finish():
        j, t_enq, handle, ev = pending.pop(0)
        fetch(handle)
        done = (e0.elapsed_time(ev) / 1e3 if cuda
                else time.perf_counter() - t0)
        win.latencies_s.append(done - (t_enq - t0))
        win.requests += 1
        win.units += units_of(handle)

    while time.perf_counter() - t0 < seconds:
        t_enq = time.perf_counter()
        handle = enqueue(i)
        ev = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            ev.record()
        pending.append((i, t_enq, handle, ev))
        if len(pending) > 1:
            finish()
        i += 1
    while pending:
        finish()
    win.seconds = time.perf_counter() - t0
    win.next_index = i
    return win


def profiled_stretch(enqueue: Callable, fetch: Callable, units_of: Callable,
                     start_index: int, count: int) -> dict:
    """After the window: one request under a first profiler session (CUDA's
    tracing starts up there), then `count` requests under the measured
    one, fetched one behind, the device synchronised at both ends. ->
    {"prof", "wall_s", "units"}."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        fetch(enqueue(start_index))
        torch.cuda.synchronize()
    units = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pending = None
        for i in range(start_index + 1, start_index + 1 + count):
            handle = enqueue(i)
            units += units_of(handle)
            if pending is not None:
                fetch(pending)
            pending = handle
        fetch(pending)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"prof": prof, "wall_s": wall, "units": units}
