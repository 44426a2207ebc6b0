"""Device time per stage from CUDA events.

Used by the inference pipeline (eval/pipeline.py) and the SplineNet trainer
(train/train_spline.py) to split a batch's or a step's time into stages.
"""
from __future__ import annotations

import contextlib

import torch


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
