"""Mean-shift clustering on the unit hypersphere.

Counterpart of parsenet_tpu/ops/mean_shift.py. `guard_mean_shift` has the
JAX package's two forms. Inference (differentiable=False): every attempt
runs the full iteration count (K1) and its NMS, and the accepted attempt is
the result. Training (differentiable=True): the attempts run without
gradient through K1 f32 for `attempt_iterations`, then the accepted
bandwidth is run again for `iterations` by `mean_shift_iterations_autograd`,
plain PyTorch with autograd (K1 has no backward), or, under
torch.no_grad(), by K1 f32 once more. In both, the bandwidth-escalation
guard (double the quantile until at most max_clusters clusters; reference
src/mean_shift.py:81-96) is a Python loop. The [N, N] products of `nms` and
`_subset_sqdist` are plain matmuls.

kernel="epanechnikov" (the JAX package runs it through XLA only: its
Pallas branch is gaussian-only) is plain PyTorch with autograd in every
branch. `mean_shift` is the pass without NMS or the guard (reference
src/mean_shift.py:19-43 with nms=False), differentiable in X.
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


def bandwidth_from_sorted(sorted_d: torch.Tensor, quantile,
                          min_bw: float = 0.003) -> torch.Tensor:
    """Mean over rows of the sqrt of the quantile-th nearest distance, from
    rows sorted ascending [S, S] (reference: src/mean_shift.py:115-137):
    column k - 1, k = clip(quantile * S, 1, S - 1) in f32, the row's own
    zero distance in column 0 as torch.topk(largest=False) leaves it."""
    s = sorted_d.shape[0]
    k = int(np.clip(int(np.float32(float(quantile)) * np.float32(s)), 1,
                    s - 1))
    bw = torch.mean(guard_sqrt(sorted_d[:, k - 1], 1e-6))
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


def mean_shift_iterations_autograd(X: torch.Tensor, bandwidth: torch.Tensor,
                                   iterations: int) -> torch.Tensor:
    """`iterations` gaussian mean-shift steps of X [N, D] as plain PyTorch
    with autograd, the JAX package's XLA mean_shift_iterations: m <-
    normalize((K @ X) / (rowsum K + 1e-12)), K = exp((2 m.X - 2) / 2b^2),
    starting from m = X. Differentiable in X (the bandwidth is a constant
    of the guard); each iteration keeps its [N, N] K for the backward."""
    inv2b2 = 1.0 / (2.0 * bandwidth * bandwidth)
    m = X
    for _ in range(iterations):
        k = torch.exp((2.0 * (m @ X.T) - 2.0) * inv2b2)
        new_m = (k @ X) / (torch.sum(k, dim=1, keepdim=True) + 1e-12)
        m = new_m / (torch.linalg.norm(new_m, dim=1, keepdim=True) + 1e-12)
    return m


def mean_shift_iterations_epanechnikov(X: torch.Tensor, bandwidth,
                                       iterations: int) -> torch.Tensor:
    """`iterations` Epanechnikov mean-shift steps of X [N, D] (the JAX
    package's XLA branch): K = relu(0.75 (1 - (2 - 2 m.X) / b^2)), m <-
    normalize((K @ X) / (rowsum K + 1e-12)), from m = X; plain PyTorch
    with autograd."""
    b2 = bandwidth ** 2
    m = X
    for _ in range(iterations):
        k = torch.relu(0.75 * (1.0 - (2.0 - 2.0 * (m @ X.T)) / b2))
        new_m = (k @ X) / (torch.sum(k, dim=1, keepdim=True) + 1e-12)
        m = new_m / (torch.linalg.norm(new_m, dim=1, keepdim=True) + 1e-12)
    return m


KERNELS = ("gaussian", "epanechnikov")


def _shift(X: torch.Tensor, bandwidth, iterations: int, kernel: str,
           bf16_dots: bool = False, tol: float = 0.0) -> torch.Tensor:
    """`iterations` steps of `kernel`: gaussian with autograd where X
    carries a gradient (mean_shift_iterations_autograd), else K1;
    Epanechnikov always in plain PyTorch."""
    if kernel == "epanechnikov":
        return mean_shift_iterations_epanechnikov(X, bandwidth, iterations)
    if torch.is_grad_enabled() and X.requires_grad:
        return mean_shift_iterations_autograd(X, bandwidth, iterations)
    return mean_shift_iterations(X, bandwidth, iterations,
                                 bf16_dots=bf16_dots, tol=tol)


def mean_shift(X: torch.Tensor, quantile: float, num_samples: int = 5000,
               iterations: int = 10, kernel: str = "gaussian",
               subset: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """One mean-shift pass without NMS (parsenet_tpu/ops/mean_shift.py:
    308-315): X [N, D] unit rows -> (shifted [N, D], bandwidth). The
    bandwidth is the mean over a row subset (subset / generator, as
    `_subset_sqdist`) of the sqrt of each row's k-th smallest squared
    distance, k = quantile x S (at least 1, below S), without gradient.
    Differentiable in X: with grad mode on and X requiring grad the
    gaussian iterations run with autograd, else on K1 f32."""
    if kernel not in KERNELS:
        raise ValueError(f"mean_shift: unknown kernel {kernel!r}")
    with torch.no_grad():
        d = _subset_sqdist(X.detach(), num_samples, subset, generator)
        s = d.shape[0]
        k = int(np.clip(int(np.float32(quantile) * np.float32(s)), 1, s - 1))
        kth = torch.kthvalue(d, k, dim=1).values
        bw = torch.clamp(torch.mean(guard_sqrt(kth, 1e-6)), min=0.003)
    return _shift(X, bw, iterations, kernel), bw


def guard_mean_shift(X: torch.Tensor, quantile: float,
                     num_samples: int = 5000, iterations: int = 10,
                     max_clusters: int = 49, max_doublings: int = 8,
                     bf16_dots: bool = False,
                     subset: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     tol: float = 0.0, differentiable: bool = False,
                     attempt_iterations: Optional[int] = None,
                     kernel: str = "gaussian") -> MeanShiftResult:
    """Mean-shift with bandwidth escalation until <= max_clusters clusters.

    X: [N, D] unit rows. subset / generator: the random subset for the
    bandwidth statistic (see _subset_sqdist); the bandwidth carries no
    gradient.

    differentiable=False (inference): each attempt runs all `iterations`
    in one K1 launch plus NMS and is the result when accepted. bf16_dots:
    bf16 operands in K1's products (the bench's setting; f32 by default).
    tol > 0: every attempt takes K1's early exit (the JAX package's
    pallas_tol), a 128-row block stopping once an iteration moves none of
    its rows by more than tol.

    differentiable=True (training, f32, tol 0): the attempts run
    `attempt_iterations` (None: `iterations`) without gradient through K1
    f32 and decide the bandwidth from their NMS; the accepted bandwidth is
    then run again for `iterations`: with autograd by
    mean_shift_iterations_autograd when grad mode is on, else by K1 f32
    (the attempt itself when it ran as many iterations). NMS reads the
    detached result, so `shifted` is the only differentiable output.

    kernel: "gaussian" (K1) or "epanechnikov" (plain PyTorch in the
    attempts and the re-run, f32, tol = 0).
    """
    if kernel not in KERNELS:
        raise ValueError(f"guard_mean_shift: unknown kernel {kernel!r}")
    if differentiable and (bf16_dots or tol):
        raise ValueError("guard_mean_shift: the differentiable branch runs "
                         "f32 attempts at tol = 0")
    if kernel != "gaussian" and (bf16_dots or tol):
        raise ValueError("guard_mean_shift: bf16_dots and tol are K1's "
                         "(gaussian) settings")
    X_ng = X.detach()
    att_iters = (attempt_iterations or iterations) if differentiable \
        else iterations

    def attempt(bw):
        shifted = _shift(X_ng, bw, att_iters, kernel, bf16_dots, tol)
        center_mask, labels, k = nms(shifted, X_ng, bw)
        return shifted, center_mask, labels, k

    with torch.no_grad():
        d_sub = _subset_sqdist(X_ng, num_samples, subset, generator)
        q = np.float32(quantile)
        bw = _initial_bandwidth(d_sub, float(quantile))
        shifted, center_mask, labels, k = attempt(bw)
        i = 0
        while k > max_clusters and i < max_doublings:
            i += 1
            q = np.float32(q * np.float32(2.0))
            bw = _escalation_bandwidth(d_sub, q)
            shifted, center_mask, labels, k = attempt(bw)
    if not differentiable or (att_iters == iterations
                              and not torch.is_grad_enabled()):
        return MeanShiftResult(shifted, center_mask, labels, bw, k)
    if torch.is_grad_enabled():
        shifted = (mean_shift_iterations_autograd(X, bw, iterations)
                   if kernel == "gaussian" else
                   mean_shift_iterations_epanechnikov(X, bw, iterations))
    else:
        shifted = _shift(X_ng, bw, iterations, kernel)
    with torch.no_grad():
        center_mask, labels, k = nms(shifted.detach(), X_ng, bw)
    return MeanShiftResult(shifted, center_mask, labels, bw, k)
