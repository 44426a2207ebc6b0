"""Eval-mode segment preprocessing for the spline decoders, batched over
spline slots.

Counterpart of parsenet_tpu/ops/preprocess.py (reference
src/primitive_forward.py:986-1036, src/fitting_utils.py:149-217, 704-710):
each slot's segment is packed into a BUF-row buffer by a uniform draw
without replacement, statistical outliers are removed (k = 20 same-segment
neighbours, mean distance, keep <= mu + 0.5 sigma), the set is doubled with
4-nearest-neighbour centroids until it reaches a_max (1,800 closed, 1,500
open) and a fixed number of rows is drawn from the result.

Every slot array has a leading axis S. The two uniform draws of a slot
(`u_pack` [S, N] for packing, `u_draw` [S, min(N, BUF)] for the final
draw, the buffer's rows) are arguments. Distances are |p|^2 - 2 p.q +
|q|^2 in f32 (TF32 off, as the entry points set it), the neighbours the
exact top-k in lax.top_k's order (knn.topk_first; the JAX package's
TPU-only approx_max_k is exact top_k off the TPU) and every argsort
stable, as jnp.argsort is.
"""
from __future__ import annotations

import torch

from ..core.profiling import trace
from .knn import topk_first

BUF = 2048          # packed segment buffer (>= a_max of closed splines, 1,800)
NB_NEIGHBORS = 20
STD_RATIO = 0.5
UPSAMPLE_ROUNDS = 6  # >= ceil(log2(1800 / (100 - outliers)))
_BIG = 1e30


def _masked_sqdist(pts: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[S, buf, buf] squared distances among the first m[s] rows of each
    slot; pairs with an invalid row and the diagonal get 1e30."""
    buf = pts.shape[1]
    sq = torch.sum(pts * pts, dim=-1)
    d = sq[:, :, None] - 2.0 * (pts @ pts.transpose(1, 2)) + sq[:, None, :]
    valid = torch.arange(buf, device=pts.device)[None, :] < m[:, None]
    keep = valid[:, :, None] & valid[:, None, :]
    keep &= ~torch.eye(buf, dtype=torch.bool, device=pts.device)
    return torch.where(keep, d, _BIG)


def pack_segment(points: torch.Tensor, member: torch.Tensor,
                 u_pack: torch.Tensor, buf: int = BUF):
    """Gather a uniformly random subset of each slot's member points to the
    front of a [buf, 3] buffer. points [N, 3], member [S, N] bool, u_pack
    [S, N] in [0, 1) -> (pts [S, min(N, buf), 3], m [S] = min(#members,
    buf))."""
    pri = u_pack + torch.where(member, 0.0, 2.0)
    order = torch.argsort(pri, dim=1, stable=True)[:, :buf]
    m = torch.clamp(torch.sum(member.to(torch.int64), dim=1), max=buf)
    return points[order], m


def statistical_inliers_packed(pts: torch.Tensor, m: torch.Tensor,
                               nb_neighbors: int = NB_NEIGHBORS,
                               std_ratio: float = STD_RATIO) -> torch.Tensor:
    """Keep flags [S, buf] of packed buffers whose first m[s] rows are valid
    (padding rows False): mean distance to the min(nb, m - 1) nearest valid
    neighbours, kept if <= mu + std_ratio sigma over the valid rows
    (population sigma; reference cpp/outlier.cpp)."""
    buf = pts.shape[1]
    valid = torch.arange(buf, device=pts.device)[None, :] < m[:, None]
    nearest = -torch.topk(-_masked_sqdist(pts, m), nb_neighbors, dim=-1,
                          sorted=True).values                 # ascending
    k_eff = torch.clamp(m - 1, 1, nb_neighbors)[:, None]
    use = torch.arange(nb_neighbors, device=pts.device)[None, None, :] \
        < k_eff[:, :, None]
    dist = torch.sqrt(torch.clamp(nearest, min=0.0))
    mean_dist = torch.sum(torch.where(use, dist, 0.0), dim=-1) / k_eff
    mf = torch.clamp(m.to(torch.float32), min=1.0)[:, None]
    mu = torch.sum(torch.where(valid, mean_dist, 0.0), dim=1,
                   keepdim=True) / mf
    var = torch.sum(torch.where(valid, (mean_dist - mu) ** 2, 0.0), dim=1,
                    keepdim=True) / mf
    return valid & (mean_dist <= mu + std_ratio * torch.sqrt(var))


def repack(pts: torch.Tensor, keep: torch.Tensor):
    """Move each slot's kept rows to the front (stable) -> (pts, new m)."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return (torch.gather(pts, 1, order[..., None].expand(pts.shape)),
            torch.sum(keep.to(torch.int64), dim=1))


def nn_centroid_upsample(pts: torch.Tensor, m: torch.Tensor,
                         a_max: torch.Tensor,
                         rounds: int = UPSAMPLE_ROUNDS):
    """While a slot's count is below its a_max (at most `rounds` times),
    append the centroid of each of its points' 4 nearest neighbours
    (reference: src/fitting_utils.py:149-164, 199-217). pts [S, buf, 3]
    packed, m [S] valid rows, a_max [S] -> (pts, new m).

    The JAX package runs this as a while_loop under vmap: a slot that is
    done keeps its state while the others go on, and the loop stops once
    every slot is done. Here each round takes only the slots still below
    a_max, and the loop stops on a host check of that set (one sync a
    round) instead of running all `rounds`."""
    pts, m = pts.clone(), m.clone()
    buf = pts.shape[1]
    idx = torch.arange(buf, device=pts.device)[None, :]
    for _ in range(rounds):
        with trace("sync.preprocess_active"):
            act = torch.nonzero(m < a_max).flatten()
        if act.numel() == 0:
            break
        p, ma = pts[act], m[act]
        nbr = topk_first(-_masked_sqdist(p, ma), 4)
        rows = torch.arange(act.numel(), device=pts.device)[:, None, None]
        cent = torch.mean(p[rows, nbr], dim=2)                 # [A, buf, 3]
        new_m = torch.clamp(2 * ma, max=buf)
        src = torch.clamp(idx - ma[:, None], 0, buf - 1)
        grow = (idx >= ma[:, None]) & (idx < new_m[:, None])
        cent = torch.gather(cent, 1, src[..., None].expand(cent.shape))
        pts[act] = torch.where(grow[..., None], cent, p)
        m[act] = new_m
    return pts, m


def draw_fixed(pts: torch.Tensor, m: torch.Tensor, n_out: int,
               u_draw: torch.Tensor) -> torch.Tensor:
    """Uniform draw without replacement of n_out rows from each slot's first
    m (wrapping, with replacement, where m < n_out). u_draw [S, buf] in
    [0, 1), buf = pts.shape[1] -> [S, n_out, 3]."""
    buf = pts.shape[1]
    valid = torch.arange(buf, device=pts.device)[None, :] < m[:, None]
    order = torch.argsort(u_draw + torch.where(valid, 0.0, 2.0),
                          dim=1, stable=True)
    ranks = (torch.arange(n_out, device=pts.device)[None, :]
             % torch.clamp(m, min=1)[:, None])
    rows = torch.gather(order, 1, ranks)
    return torch.gather(pts, 1, rows[..., None].expand(-1, -1, 3))


def eval_segment_points(points: torch.Tensor, member: torch.Tensor,
                        a_max: torch.Tensor, u_pack: torch.Tensor,
                        u_draw: torch.Tensor, n_out: int = 1800
                        ) -> torch.Tensor:
    """Eval-mode preprocessing of S segments of one shape: pack, remove
    outliers, upsample to a_max, draw n_out rows from the whole upsampled
    set (callers take the first a_max rows per decoder). points [N, 3],
    member [S, N] bool, a_max [S] int, u_pack [S, N], u_draw [S, min(N,
    BUF)] -> [S, n_out, 3]."""
    with trace("preprocess.pack"):
        pts, m = pack_segment(points, member, u_pack)
    with trace("preprocess.outliers"):
        pts, m = repack(pts, statistical_inliers_packed(pts, m))
    with trace("preprocess.upsample"):
        pts, m = nn_centroid_upsample(pts, m, a_max)
    with trace("preprocess.draw"):
        return draw_fixed(pts, m, n_out, u_draw)
