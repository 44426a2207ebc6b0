"""Tracing and profiling.

Counterpart of parsenet_tpu/core/profiling.py:
* `trace`: the program's span, a torch.profiler.record_function range
  while a profiler session records and a shared no-op context otherwise
  (one flag check). Spans share the profiler's clock with the device's
  operations and nest: `entry.<name>` around a request or an optimizer
  step of an entry point, `sync.<site>` around each host synchronisation
  the entry makes, `ms.<part>` around the mean-shift guard's parts, and
  a few sub-stage spans where a stage's host work is long. Run any entry
  under torch.profiler.profile to see them;
* `StepTimer`: wall-clock step statistics, the step's device synchronised
  before the clock is read;
* `StageTimer`: device time per stage from CUDA events, used by the
  inference pipeline (eval/pipeline.py) and the trainers to split a
  batch's or a step's time into stages.
"""
from __future__ import annotations

import contextlib
import time
from typing import ContextManager, Dict, Optional

import numpy as np
import torch


_OFF = contextlib.nullcontext()


def trace(name: str) -> ContextManager:
    """A span named `name`: a record_function range while a profiler
    session is active, else the shared no-op context, which records
    nothing and allocates nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class StepTimer:
    """Per-step timing with a percentile summary. `stop(device)`
    synchronises that CUDA device first, so asynchronous launches do not
    hide device time."""

    def __init__(self, skip_first: int = 2):
        self.times = []
        self.skip_first = skip_first
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, device=None) -> float:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self, device=None):
        self.start()
        yield
        self.stop(device)

    def summary(self) -> Dict[str, float]:
        ts = np.array(self.times[self.skip_first:] or self.times)
        return {
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p90_s": float(np.percentile(ts, 90)),
            "steps_per_s": float(1.0 / ts.mean()) if ts.mean() > 0 else 0.0,
            "n": int(len(ts)),
        }


class StageTimer:
    """Device time per pipeline stage from CUDA events. Each `with
    timer(stage)` records an event pair on the current stream; `ms()`
    synchronises and sums them. Disabled (a no-op) off the card."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.events.setdefault(stage, []).append((start, end))

    def ms(self) -> dict[str, float]:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.events.items()}
