"""Optimizer and gradient guard of the trainers.

Counterpart of parsenet_tpu/train/state.py. There the optimizer is optax's
chain scale_by_adam (b1 0.9, b2 0.999, eps 1e-8 added outside the square
root, both moments bias-corrected) -> x lr, injected per step -> x -1.
`torch.optim.Adam` with the same betas and eps, its lr set before every
step, is the same update; the tests hold the two against each other.
"""
from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adam",
                   lr: float = 1e-3) -> torch.optim.Optimizer:
    """Adam (or plain SGD) whose lr the trainer sets per step with
    `set_lr`."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"make_optimizer: unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def grad_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """True iff every gradient entry is finite (reference: src/utils.py:
    393-399, the grad-norm NaN/Inf guard)."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()
