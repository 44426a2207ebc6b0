"""Readings of a traced run: the device kernels of the profiler capture,
their busy time and idle share, the breakdown, and the context the
per-layer metric readers (benchmark/metrics/<metric>.py) take.

A reader is `read(r: Reading) -> float | None`; None (nothing to read)
leaves the metric out of the line. No reader returns 0 for a share.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import counts

# the mean-shift kernels (K1 bf16, K1 f32 and their early exit) by the
# names of their __global__ functions in parsenet_tpu_torch/csrc/
MEAN_SHIFT_KERNELS = ("ms_tc_kernel", "ms_tf32_kernel", "ms_exit_kernel")


def device_kernels(prof) -> list:
    """(name, start_us, end_us) of every device operation of a capture:
    kernels, copies and sets, without the device-side mirrors of the host's
    record_function ranges (which span whole stages)."""
    host = {e.name for e in prof.events()
            if getattr(e, "is_user_annotation", False)}
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.name not in host):
            out.append((e.name, float(e.time_range.start),
                        float(e.time_range.end)))
    return sorted(out, key=lambda k: k[1])


def union_us(spans) -> tuple:
    """(busy microseconds, merged intervals) of (start, end) pairs."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def host_ranges(prof) -> list:
    """(name, start_us, end_us) of the host's record_function ranges."""
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and getattr(e, "is_user_annotation", False)):
            out.append((e.name, float(e.time_range.start),
                        float(e.time_range.end)))
    return out


def breakdown(kernels, merged, ranges, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between them, each named by the innermost host range over its
    middle ("host" where none is)."""
    by_name: dict = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for (_, b), (a, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (a + b)
        over = [r for r in ranges if r[1] <= mid <= r[2]]
        name = min(over, key=lambda r: r[2] - r[1])[0] if over else "host"
        gaps.append((name, (a - b) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}


class Reading:
    """What the per-layer readers take: the cell ("infer" shapes or
    "train" steps as the unit), the stage times of the traced window in ms
    summed, the units it completed and its seconds, the cell's counts a
    unit (flops, mean_shift: counts of one accepted bandwidth's iterations
    a shape, shapes a unit) and the profiler capture's kernels."""

    def __init__(self, kind: str, stage_ms: dict, units: int,
                 requests: int, seconds: float, unit_counts: dict,
                 capture: Optional[dict]):
        self.kind = kind
        self.stage_ms = stage_ms
        self.units = units
        self.requests = requests
        self.seconds = seconds
        self.unit_counts = unit_counts
        self.kernels, self.busy_us, self.wall_s, self.merged = [], 0.0, 0.0, []
        self.ranges, self.capture_units = [], 0
        if capture is not None:
            self.kernels = device_kernels(capture["prof"])
            self.busy_us, self.merged = union_us(
                (a, b) for _, a, b in self.kernels)
            self.ranges = host_ranges(capture["prof"])
            self.wall_s = capture["wall_s"]
            self.capture_units = capture["units"]

    def per_unit(self, *stages: str) -> Optional[float]:
        """ms of the summed stages a shape (inference) or a step
        (training); None where the program marked none of them."""
        got = [self.stage_ms[s] for s in stages if s in self.stage_ms]
        if not got or self.requests == 0:
            return None
        per = self.units if self.kind == "infer" else self.requests
        return sum(got) / per

    def idle_share(self) -> Optional[float]:
        """% of the profiled stretch in which no device operation ran."""
        if not self.kernels or self.wall_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_us / 1e6 / self.wall_s)

    def mfu(self) -> Optional[float]:
        """% of the bf16 peak: the model FLOPs of the window's completed
        work over its seconds."""
        if self.units == 0 or self.seconds <= 0:
            return None
        flops = self.unit_counts["flops_per_shape"] * self.units
        return 100.0 * flops / self.seconds / counts.PEAK_FLOPS

    def mean_shift_roofline(self) -> Optional[float]:
        """% of the least time (counts.least_seconds of one accepted
        bandwidth's iterations a shape, times the shapes of the profiled
        stretch) that the mean-shift kernels' device time reached."""
        t = sum(b - a for name, a, b in self.kernels
                if any(k in name for k in MEAN_SHIFT_KERNELS)) / 1e6
        if t <= 0 or self.capture_units == 0:
            return None
        least = (counts.least_seconds(self.unit_counts["mean_shift"])
                 * self.capture_units)
        return 100.0 * least / t

    def device(self) -> dict:
        return {"busy_s": self.busy_us / 1e6, "window_s": self.wall_s}

    def breakdown(self) -> Optional[dict]:
        if not self.kernels:
            return None
        return breakdown(self.kernels, self.merged, self.ranges)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
