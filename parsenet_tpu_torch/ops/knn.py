"""k-nearest-neighbour graph construction (exact).

Counterpart of parsenet_tpu/ops/knn.py. The pairwise scores are computed in
query-row chunks so peak memory is O(chunk * N), and the neighbours are the
exact top-k (`torch.topk`): the JAX package's `lax.approx_max_k` is a TPU
primitive, and on other backends it takes this exact path too.

Two metrics:
  * `knn`: squared euclidean distance on the feature channels;
  * `knn_points_normals`: the joint metric d = d_p * (1 + d_n) with
    d_n = 2 - 2 <n_i, n_j>, for the first EdgeConv of the points+normals
    model (reference: src/PointNet.py:29-69).
k2 > k1 gives the reference's dilated selection (top-k2, stride k2 // k1).
"""
from __future__ import annotations

from typing import Optional

import torch

CHUNK_TARGET = 2500


def _row_chunks(n: int, target: int = CHUNK_TARGET) -> int:
    """A query-chunk size that divides n and is close to `target`."""
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def _topk_neighbors(neg_dist: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    idx = torch.topk(neg_dist, k2, dim=-1, sorted=True).indices
    stride = max(k2 // k1, 1)
    if stride > 1:
        idx = idx[..., ::stride]
    return idx[..., :k1]


@torch.no_grad()
def knn(x: torch.Tensor, k1: int, k2: Optional[int] = None) -> torch.Tensor:
    """Batched kNN indices. x: [B, N, C] -> [B, N, k1] int64."""
    k2 = k2 or k1
    b, n, _ = x.shape
    c = _row_chunks(n)
    out = []
    for bi in range(b):
        xb = x[bi]
        xx = torch.sum(xb * xb, dim=-1)
        rows = []
        for s in range(0, n, c):
            q = xb[s:s + c]
            neg = 2.0 * (q @ xb.T)
            neg = neg - torch.sum(q * q, dim=-1, keepdim=True) - xx[None, :]
            rows.append(_topk_neighbors(neg, k1, k2))
        out.append(torch.cat(rows))
    return torch.stack(out)


@torch.no_grad()
def knn_points_normals(x: torch.Tensor, k1: int,
                       k2: Optional[int] = None) -> torch.Tensor:
    """Batched joint point/normal kNN. x: [B, N, 6] -> [B, N, k1] int64."""
    k2 = k2 or k1
    b, n, _ = x.shape
    c = _row_chunks(n)
    out = []
    for bi in range(b):
        p, nrm = x[bi, :, :3], x[bi, :, 3:6]
        pp = torch.sum(p * p, dim=-1)
        rows = []
        for s in range(0, n, c):
            qp, qn = p[s:s + c], nrm[s:s + c]
            d_p = (torch.sum(qp * qp, -1, keepdim=True) - 2.0 * (qp @ p.T)
                   + pp[None, :])
            d_n = 2.0 - 2.0 * (qn @ nrm.T)
            rows.append(_topk_neighbors(-(d_p * (1.0 + d_n)), k1, k2))
        out.append(torch.cat(rows))
    return torch.stack(out)


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features. x: [B, N, C], idx: [B, N, k] -> [B, N, k, C]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]
