"""The plain reference that decides `correct`, and its comparisons.

`plain/` is a frozen copy of the port's plain PyTorch paths (see its
docstring); `infer.py` and `train.py` run it on the inputs the benchmark
made, and `compare.py` holds the numbers that are compared with their
limits. `precision(low=True)` computes the reference one step below the
precision each configuration states, the control that has to come out not
correct: TF32 for every float32 product, float8 (e4m3) operands where
mean-shift states bfloat16.
"""
from __future__ import annotations

import contextlib

import torch

from .plain.core import guards
from .plain.ops import kernels


@contextlib.contextmanager
def precision(low: bool = False):
    """The reference's precision: the configurations' (TF32 off, bf16
    mean-shift operands where bf16 is stated) or, with low, the control's."""
    saved = (guards.TF32["on"], kernels.MS_LOW["dtype"])
    guards.TF32["on"] = low
    kernels.MS_LOW["dtype"] = torch.float8_e4m3fn if low else torch.bfloat16
    guards.set_fp32_policy()
    try:
        yield
    finally:
        guards.TF32["on"], kernels.MS_LOW["dtype"] = saved
        guards.set_fp32_policy()
