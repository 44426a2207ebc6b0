"""Minimum squared distances (the chamfer core).

Counterpart of parsenet_tpu/ops/chamfer.min_sqdist. Every call goes through
K3 (`kernels.min_sqdist_with_idx`), whose masked targets get +1e30 as in the
TPU kernel; the JAX package's own XLA fallback masks with 1e10 instead,
which only shows where every target of a query is masked.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels import min_sqdist_with_idx


def min_sqdist(q: torch.Tensor, x: torch.Tensor,
               x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-query min squared distance. q: [N, 3], x: [M, 3] -> [N]."""
    return min_sqdist_with_idx(q.contiguous(), x.contiguous(), x_mask)[0]
