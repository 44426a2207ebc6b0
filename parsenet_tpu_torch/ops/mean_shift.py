"""Mean-shift clustering on the unit hypersphere, inference form.

Counterpart of parsenet_tpu/ops/mean_shift.py for guard_mean_shift with
differentiable=False: every attempt runs the full iteration count (K1) and
its NMS, and the bandwidth-escalation guard (double the quantile until at
most max_clusters clusters; reference src/mean_shift.py:81-96) is a Python
loop. The [N, N] products of `nms` and `_subset_sqdist` are plain matmuls.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.guards import guard_sqrt
from .kernels import mean_shift_iterations


class MeanShiftResult(NamedTuple):
    shifted: torch.Tensor       # [N, D] shifted embedding per point
    center_mask: torch.Tensor   # [N] 1.0 where the point is a surviving center
    labels: torch.Tensor        # [N] int64 compacted cluster id per point
    bandwidth: torch.Tensor     # scalar
    num_clusters: int


def _subset_sqdist(X: torch.Tensor, num_samples: int,
                   subset: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Pairwise squared distances [S, S] of a random subset of the rows of X.

    `subset` gives the row indices (at least S of them; the first S are
    used), else they are drawn from `generator`; with neither, or when
    S = N, the first S rows are taken, as the JAX package does without a key.
    """
    n = X.shape[0]
    s = min(num_samples, n)
    if s < n and subset is not None:
        xs = X[subset[:s].to(device=X.device, dtype=torch.int64)]
    elif s < n and generator is not None:
        xs = X[torch.randperm(n, generator=generator, device=X.device)[:s]]
    else:
        xs = X[:s]
    return 2.0 - 2.0 * (xs @ xs.T)


def _kth_smallest_per_row(d: torch.Tensor, k: int,
                          iters: int = 28) -> torch.Tensor:
    """Per-row k-th smallest (1-indexed) of d [S, S] by 28 halvings of the
    unit-sphere distance range [0, 4]: [S]."""
    s = d.shape[0]
    lo = torch.zeros(s, dtype=torch.float32, device=d.device)
    hi = torch.full((s,), 4.0 + 1e-3, dtype=torch.float32, device=d.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum((d <= mid[:, None]).to(torch.float32), dim=1)
        ge = cnt >= float(k)
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


def _escalation_bandwidth(d: torch.Tensor, quantile: np.float32,
                          min_bw: float = 0.003) -> torch.Tensor:
    """Bandwidth at a doubled quantile (escalation path), sort-free."""
    s = d.shape[0]
    k = int(np.clip(int(np.float32(quantile) * np.float32(s)), 1, s - 1))
    bw = torch.mean(guard_sqrt(_kth_smallest_per_row(d, k), 1e-6))
    return torch.clamp(bw, min=min_bw)


def _initial_bandwidth(d: torch.Tensor, quantile: float,
                       min_bw: float = 0.003) -> torch.Tensor:
    """Mean over rows of the sqrt of the k-th smallest distance, k =
    quantile * S (exact top-k)."""
    s = d.shape[0]
    k = int(min(max(quantile * s, 1), s - 1))
    kth = torch.topk(d, k, dim=1, largest=False, sorted=True).values[:, -1]
    bw = torch.mean(guard_sqrt(kth, 1e-6))
    return torch.clamp(bw, min=min_bw)


def nms(shifted: torch.Tensor, X: torch.Tensor, bandwidth: torch.Tensor):
    """Fixed-shape non-max suppression (reference src/mean_shift.py:139-179).
    Returns (center_mask [N], labels [N] int64 compacted, num_clusters)."""
    n = X.shape[0]
    scores = shifted @ X.T                                   # [N, N]
    member_of = torch.argmax(scores, dim=0)
    counts = torch.bincount(member_of, minlength=n).to(torch.float32)
    valid = (counts > 0).to(torch.float32)
    # centers within `bandwidth` of each other compete; the one with the
    # most members wins (squared-distance scale, as the reference)
    cdist = 2.0 - 2.0 * (shifted @ shifted.T)
    nbrs = (cdist < bandwidth).to(torch.float32)
    del cdist
    winner = torch.argmax(nbrs * counts[None, :], dim=1)
    del nbrs
    center_mask = torch.zeros(n, dtype=torch.float32, device=X.device)
    center_mask = center_mask.scatter_reduce(0, winner, valid, reduce="amax")
    masked = torch.where(center_mask[:, None] > 0, scores,
                         torch.tensor(float("-inf"), device=X.device))
    best_center = torch.argmax(masked, dim=0)
    rank = torch.cumsum(center_mask, dim=0).to(torch.int64) - 1
    labels = rank[best_center]
    num_clusters = int(torch.sum(center_mask).item())
    return center_mask, labels, num_clusters


@torch.no_grad()
def guard_mean_shift(X: torch.Tensor, quantile: float,
                     num_samples: int = 5000, iterations: int = 10,
                     max_clusters: int = 49, max_doublings: int = 8,
                     bf16_dots: bool = False,
                     subset: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> MeanShiftResult:
    """Mean-shift with bandwidth escalation until <= max_clusters clusters.

    X: [N, D] unit rows. Each attempt runs all `iterations` in one K1
    launch plus NMS and is the result when accepted. bf16_dots: bf16
    operands in K1's products (the bench's setting; f32 by default).
    subset / generator: the random subset for the bandwidth statistic
    (see _subset_sqdist).
    """
    d_sub = _subset_sqdist(X, num_samples, subset, generator)

    def full(bw):
        shifted = mean_shift_iterations(X, bw, iterations, bf16_dots=bf16_dots)
        center_mask, labels, k = nms(shifted, X, bw)
        return shifted, center_mask, labels, k

    q = np.float32(quantile)
    bw = _initial_bandwidth(d_sub, float(quantile))
    shifted, center_mask, labels, k = full(bw)
    i = 0
    while k > max_clusters and i < max_doublings:
        i += 1
        q = np.float32(q * np.float32(2.0))
        bw = _escalation_bandwidth(d_sub, q)
        shifted, center_mask, labels, k = full(bw)
    return MeanShiftResult(shifted, center_mask, labels, bw, k)
