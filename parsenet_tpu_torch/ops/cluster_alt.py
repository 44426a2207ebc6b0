"""Alternative clustering backends.

Counterpart of parsenet_tpu/ops/cluster_alt.py (reference
src/segment_utils.py:13-76, `cluster` and `cluster_prob`): besides the
differentiable mean-shift, embeddings can be segmented by KMeans (Lloyd's
iterations from a farthest-point initialisation) or normalised-cut spectral
clustering (gaussian affinity, normalised by degree, eigenvectors by
orthogonal subspace iteration, then KMeans on the row-normalised
eigenvectors), and memberships can be softmax, gaussian or
temperature-softmax functions of the centres. All of it is plain PyTorch on
the device; the "meanshift" branch of `cluster` is ops.mean_shift.
guard_mean_shift (K1 f32 on the card).

The random draws are arguments: KMeans's first centre (a row index) and
spectral clustering's starting subspace V0 [N, k] with its KMeans's first
index; `cluster` draws whichever it is not given from `generator`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _sqdist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(|x|^2 - 2 x.c) + |c|^2: [N, k]."""
    return (torch.sum(X * X, dim=1)[:, None] - 2.0 * (X @ C.T)
            + torch.sum(C * C, dim=1)[None, :])


def kmeans(X: torch.Tensor, k: int, first: int, iters: int = 25
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm from a farthest-point initialisation: X [N, D],
    first the row of the first centre -> (labels [N] int64, centres
    [k, D]). Each further initial centre is the row farthest from those
    chosen (the first such row on ties); an empty cluster keeps its
    centre."""
    centers = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    c = X[int(first)]
    centers[0] = c
    mind = torch.sum((X - c) ** 2, dim=1)
    for i in range(1, k):
        c = X[torch.argmax(mind)]
        centers[i] = c
        mind = torch.minimum(mind, torch.sum((X - c) ** 2, dim=1))
    for _ in range(iters):
        lab = torch.argmin(_sqdist(X, centers), dim=1)
        oh = torch.nn.functional.one_hot(lab, k).to(X.dtype)     # [N, k]
        sums = oh.T @ X
        counts = torch.sum(oh, dim=0)[:, None]
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                              centers)
    return torch.argmin(_sqdist(X, centers), dim=1), centers


def spectral_cluster(X: torch.Tensor, k: int, v0: torch.Tensor,
                     kmeans_first: int, sigma: float = 0.5,
                     power_iters: int = 60, kmeans_iters: int = 25
                     ) -> torch.Tensor:
    """Normalised-cut spectral clustering: X [N, D], v0 [N, k] the
    starting subspace, kmeans_first the first centre of the final KMeans
    -> labels [N] int64. The affinity exp(-d^2 / 2 sigma^2) is normalised
    by degree, power_iters products with it each re-orthonormalised by QR
    give its leading eigenvectors, whose rows, normalised, are clustered."""
    d2 = _sqdist(X, X)
    A = torch.exp(-d2 / (2.0 * sigma * sigma))
    dinv = 1.0 / torch.sqrt(torch.sum(A, dim=1) + 1e-9)
    M = A * dinv[:, None] * dinv[None, :]
    V = v0.to(X.dtype)
    for _ in range(power_iters):
        V = torch.linalg.qr(M @ V).Q
    rows = V / (torch.linalg.norm(V, dim=1, keepdim=True) + 1e-9)
    return kmeans(rows, k, kmeans_first, iters=kmeans_iters)[0]


def cluster(embedding: torch.Tensor, k: int, method: str = "kmeans",
            first: Optional[int] = None, v0: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            quantile: float = 0.015,
            subset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Labels [N] of embedding [N, D] by `method` (reference
    segment_utils.py:13-36): "kmeans" (first: the first centre), "spectral"
    (v0 [N, k] and first: its KMeans's first centre) or "meanshift"
    (guard_mean_shift of the row-normalised embedding at `quantile`, 30
    iterations; subset: the bandwidth rows). A draw not given comes from
    `generator` (on the embedding's device)."""
    n, dev = embedding.shape[0], embedding.device
    if method not in ("kmeans", "spectral", "meanshift"):
        raise ValueError(f"cluster: unknown method {method!r}")
    if method == "meanshift":
        from .mean_shift import guard_mean_shift
        emb = embedding / (torch.linalg.norm(embedding, dim=1, keepdim=True)
                           + 1e-12)
        return guard_mean_shift(emb, quantile, iterations=30, subset=subset,
                                generator=generator).labels
    if method == "spectral" and v0 is None:
        v0 = torch.randn((n, k), generator=generator, device=dev)
    if first is None:
        first = int(torch.randint(n, (), generator=generator, device=dev))
    if method == "kmeans":
        return kmeans(embedding, k, first)[0]
    return spectral_cluster(embedding, k, v0, first)


def cluster_prob_softmax(embedding: torch.Tensor,
                         centers: torch.Tensor) -> torch.Tensor:
    """Softmax membership over the centres (reference segment_utils.py:
    39-50): embedding [N, D], centers [C, D] -> [N, C]."""
    return torch.softmax(embedding @ centers.T, dim=1)


def cluster_prob_gaussian(embedding: torch.Tensor, centers: torch.Tensor,
                          band_width) -> torch.Tensor:
    """Gaussian kernel membership (reference segment_utils.py:52-61) ->
    [C, N]."""
    dist = 2.0 - 2.0 * (centers @ embedding.T)
    norm = torch.sqrt(torch.as_tensor(2.0 * math.pi * band_width,
                                      dtype=dist.dtype, device=dist.device))
    return torch.exp(-dist / 2.0 / band_width) / norm


def cluster_prob_mutual(embedding: torch.Tensor, centers: torch.Tensor,
                        bandwidth, if_normalize: bool = False
                        ) -> torch.Tensor:
    """Temperature-softmax membership over the centres, optionally min-max
    normalised a centre (reference segment_utils.py:64-76) -> [C, N]."""
    dist = torch.exp((centers @ embedding.T) / bandwidth)
    prob = dist / torch.sum(dist, dim=0, keepdim=True)
    if if_normalize:
        prob = prob - torch.amin(prob, dim=1, keepdim=True)
        prob = prob / torch.amax(prob, dim=1, keepdim=True)
    return prob
