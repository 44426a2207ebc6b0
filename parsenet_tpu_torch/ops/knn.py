"""k-nearest-neighbour graph construction (exact).

Counterpart of parsenet_tpu/ops/knn.py. The pairwise scores of all B
clouds are computed in query-row chunks, one batched product each, so peak
memory is O(B * chunk * N), and the neighbours are the exact top-k
(`torch.topk`): the JAX package's `lax.approx_max_k` is a TPU primitive,
and on other backends it takes this exact path too. `topk_first` is the
exact top-k in lax.top_k's order, for the spline preprocessing, where
that order decides which of exactly tied candidates feed a centroid.

Two metrics:
  * `knn`: squared euclidean distance on the feature channels;
  * `knn_points_normals`: the joint metric d = d_p * (1 + d_n) with
    d_n = 2 - 2 <n_i, n_j>, for the first EdgeConv of the points+normals
    model (reference: src/PointNet.py:29-69).
k2 > k1 gives the reference's dilated selection (top-k2, stride k2 // k1).

`knn_graph` is the DGCNN's entry for its three graphs a forward: on the
card, f32 at the kernel's widths and k <= 128, it is one K6 launch
(kernels.knn_graph: scores and exact top-k on chip, no score matrix in
device memory, torch.topk's graph; equal scores in index order, as
lax.top_k orders them); everything else (CPU tensors, bf16 features,
other widths) takes `knn` / `knn_points_normals` as they are. It builds
no dilated graph: that is `knn`'s k2.

bf16 features (the bf16 network's second and third graphs) are scored as
the JAX package scores them: the inner products of the bf16 values taken
in f32 (exact products, f32 sums: its preferred_element_type=f32), the
squared norms summed in f32 and rounded to bf16, as its bf16 jnp.sum
leaves them. A bf16 `q @ xt` would round every score to bf16, tie far
more neighbours and build another graph.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.profiling import trace
from . import kernels

CHUNK_TARGET = 2500


def _row_chunks(n: int, target: int = CHUNK_TARGET) -> int:
    """A query-chunk size that divides n and is close to `target`."""
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def pairwise_sqdist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance between row sets: [M, C] x [N, C] ->
    [M, N], as |q|^2 - 2 <q, x> + |x|^2."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    return qq - 2.0 * (q @ x.T) + xx.T


def topk_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of f32 x, in descending
    order, equal values in ascending index order: lax.top_k's order, which
    torch.topk does not promise. Each entry becomes one int64 key, its
    value's bits made order-preserving (lax.top_k's total order: -0.0 below
    +0.0) in the high word and n - 1 - index in the low word, so no two
    keys tie and one torch.topk gives that order, with no host sync."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    low = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    return torch.topk(key * (1 << 32) + low, k, dim=-1, sorted=True).indices


def _topk_neighbors(neg_dist: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    idx = torch.topk(neg_dist, k2, dim=-1, sorted=True).indices
    stride = max(k2 // k1, 1)
    if stride > 1:
        idx = idx[..., ::stride]
    return idx[..., :k1]


@torch.no_grad()
def knn(x: torch.Tensor, k1: int, k2: Optional[int] = None) -> torch.Tensor:
    """Batched kNN indices. x: [B, N, C] -> [B, N, k1] int64. Each query-row
    chunk is one batched product over the B clouds and one topk."""
    k2 = k2 or k1
    n = x.shape[1]
    c = _row_chunks(n)
    x, low = x.float(), x.dtype == torch.bfloat16

    def sqnorm(v):
        sq = torch.sum(v * v, dim=-1)
        return sq.to(torch.bfloat16).float() if low else sq

    xx = sqnorm(x)[:, None, :]                               # [B, 1, N]
    xt = x.transpose(1, 2)
    rows = []
    for s in range(0, n, c):
        q = x[:, s:s + c]
        neg = 2.0 * (q @ xt)
        neg = neg - sqnorm(q)[..., None] - xx
        rows.append(_topk_neighbors(neg, k1, k2))
    return torch.cat(rows, dim=1)


@torch.no_grad()
def knn_points_normals(x: torch.Tensor, k1: int,
                       k2: Optional[int] = None) -> torch.Tensor:
    """Batched joint point/normal kNN. x: [B, N, 6] -> [B, N, k1] int64, one
    batched product pair and one topk per query-row chunk."""
    k2 = k2 or k1
    n = x.shape[1]
    c = _row_chunks(n)
    p, nrm = x[..., :3], x[..., 3:6]
    pp = torch.sum(p * p, dim=-1)[:, None, :]                # [B, 1, N]
    pt, nt = p.transpose(1, 2), nrm.transpose(1, 2)
    rows = []
    for s in range(0, n, c):
        qp, qn = p[:, s:s + c], nrm[:, s:s + c]
        d_p = torch.sum(qp * qp, -1, keepdim=True) - 2.0 * (qp @ pt) + pp
        d_n = 2.0 - 2.0 * (qn @ nt)
        rows.append(_topk_neighbors(-(d_p * (1.0 + d_n)), k1, k2))
    return torch.cat(rows, dim=1)


@torch.no_grad()
def knn_graph(x: torch.Tensor, k: int, *,
              points_normals: bool = False) -> torch.Tensor:
    """The DGCNN's kNN graph, x [B, N, C] -> [B, N, k] int64: the joint
    point/normal metric with points_normals, else squared distance. K6
    on the card where `kernels.knn_graph_fits`, else `knn_points_normals`
    / `knn`. One `knn.graph` span a graph."""
    with trace("knn.graph"):
        if x.device.type == "cuda" and kernels.knn_graph_fits(
                x, k, points_normals):
            return kernels.knn_graph(x.contiguous(), k, points_normals)
        if points_normals:
            return knn_points_normals(x, k)
        return knn(x, k)


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features. x: [B, N, C], idx: [B, N, k] -> [B, N, k, C]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


def edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """EdgeConv features concat(x_j - x_i, x_i): x [B, N, C], idx [B, N, k]
    -> [B, N, k, 2C] (reference: src/PointNet.py:72-103)."""
    nbrs = gather_neighbors(x, idx)
    center = x[:, :, None, :].expand_as(nbrs)
    return torch.cat([nbrs - center, center], dim=-1)
