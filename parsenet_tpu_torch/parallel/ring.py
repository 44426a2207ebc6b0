"""Point-axis sharding of the pairwise kernels as ring passes.

Counterpart of parsenet_tpu/parallel/ring.py. Each rank holds a shard of
the queries and a shard of the targets; the target shards travel around
the ring (rank r sends to r + 1 and receives from r - 1, isend / irecv)
while every rank folds the visiting shard into its running result. At step
s rank r holds the shard that rank (r - s) mod W started with, so a rank
visits its own shard first, then its predecessors' in ring order.

* `ring_min_sqdist`: the chamfer core, the running minimum squared
  distance and its global argmin. The local fold is K3
  (kernels.min_sqdist_with_idx) on the card and its plain version on the
  CPU; a visiting shard replaces the incumbent only where it is strictly
  smaller, so of equal distances the shard visited first wins, as in the
  JAX ring, not the lowest global index.
* `ring_knn`: the running top-k of -(squared distance), merged with
  knn.topk_first (lax.top_k's order: the incumbent first among ties).

Both take this rank's shards; all shards have the same number of rows.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ops.kernels import min_sqdist_with_idx
from ..ops.knn import _row_chunks, topk_first
from .mesh import Mesh


def _ring_passes(mesh: Mesh, fold, init, shard: torch.Tensor):
    """fold(carry, shard, src) over the W shards as they pass this rank:
    its own first, then the one from (rank - step) mod W at each step."""
    w, me = mesh.world, mesh.rank
    carry, cur = init, shard.contiguous()
    for step in range(w):
        src = (me - step) % w
        carry = fold(carry, cur, src)
        if step + 1 < w:
            nxt = torch.empty_like(cur)
            ops = [dist.P2POp(dist.isend, cur, (me + 1) % w),
                   dist.P2POp(dist.irecv, nxt, (me - 1) % w)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            cur = nxt
    return carry


@torch.no_grad()
def ring_min_sqdist(mesh: Mesh, q: torch.Tensor, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's queries q [N_local, 3] against the targets of every
    rank (x [M_local, 3] here): (min squared distance [N_local] f32,
    global argmin [N_local] int32) -> rank r's shard of the JAX ring's
    (d, idx)."""
    m_local = x.shape[0]

    def fold(carry, shard, src):
        d_best, i_best = carry
        d, i = min_sqdist_with_idx(q, shard)
        better = d < d_best
        return (torch.where(better, d, d_best),
                torch.where(better, i + src * m_local, i_best))

    init = (torch.full((q.shape[0],), 1e30, dtype=torch.float32,
                       device=q.device),
            torch.zeros(q.shape[0], dtype=torch.int32, device=q.device))
    return _ring_passes(mesh, fold, init, x)


@torch.no_grad()
def ring_knn(mesh: Mesh, x: torch.Tensor, k: int) -> torch.Tensor:
    """Global indices [N_local, k] of the k nearest neighbours of this
    rank's points x [N_local, C] among every rank's: the JAX ring's
    running top-k (scores 2 q.x - |q|^2 - |x|^2, each visiting shard's
    min(k, M_local) best appended after the incumbent, the k best kept in
    lax.top_k's order). The scores are formed as knn.knn forms them, in
    the same query-row chunks, so one rank's graph is knn's."""
    n = x.shape[0]
    xb = x[None]
    qq = torch.sum(xb * xb, dim=-1)[..., None]               # [1, N, 1]
    chunk = _row_chunks(n)

    def fold(carry, shard, src):
        best_v, best_i = carry
        sb = shard[None]
        st, ss = sb.transpose(1, 2), torch.sum(sb * sb, dim=-1)[:, None, :]
        neg = torch.cat([(2.0 * (xb[:, s:s + chunk] @ st)
                          - qq[:, s:s + chunk] - ss)[0]
                         for s in range(0, n, chunk)])
        sel = topk_first(neg, min(k, shard.shape[0]))
        v = torch.gather(neg, 1, sel)
        i = sel.to(torch.int32) + src * shard.shape[0]
        cat_v = torch.cat([best_v, v], dim=1)
        cat_i = torch.cat([best_i, i], dim=1)
        keep = topk_first(cat_v, k)
        return torch.gather(cat_v, 1, keep), torch.gather(cat_i, 1, keep)

    init = (torch.full((n, k), -1e30, dtype=torch.float32, device=x.device),
            torch.zeros((n, k), dtype=torch.int32, device=x.device))
    return _ring_passes(mesh, fold, init, x)[1]
