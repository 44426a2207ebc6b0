"""Embedding (triplet) and primitive-classification losses.

Counterpart of parsenet_tpu/losses/embedding.py (reference
src/segment_loss.py:31-152): the reference's per-shape numpy triplet loop
as fixed-shape sampling.

* points per segment: P = 30 drawn with replacement from each of the
  S_MAX segment slots, index start[s] + floor(u * count[s]) into the
  point order sorted by label;
* segment pairs: N_PAIRS = 25 ordered pairs of present segments, at most
  u^2 of them counted, pairs with k1 == k2 skipped;
* shapes with a single segment are left out of the batch mean.

The uniforms are arguments, as every random draw of the port: u_points
[B, S_MAX, P_SAMPLES] and u_pairs [B, N_PAIRS, 2] in [0, 1) (`draw_triplet`
makes them from a torch.Generator; the parity tests pass the JAX package's
draws).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.profiling import trace

S_MAX = 50     # max GT segments per shape
P_SAMPLES = 30
N_PAIRS = 25   # max_segments^2 with max_segments=5 (reference: :38,86)


def draw_triplet(batch: int, generator: Optional[torch.Generator] = None,
                 device=None):
    """(u_points [batch, S_MAX, P_SAMPLES], u_pairs [batch, N_PAIRS, 2])
    uniforms in [0, 1) from `generator`."""
    return (torch.rand((batch, S_MAX, P_SAMPLES), generator=generator,
                       device=device),
            torch.rand((batch, N_PAIRS, 2), generator=generator,
                       device=device))


def _triplet_one_shape(emb: torch.Tensor, labels: torch.Tensor,
                       u_points: torch.Tensor, u_pairs: torch.Tensor,
                       margin: float):
    """emb [N, D] unit rows, labels [N] int in [0, S_MAX), u_points
    [S_MAX, P_SAMPLES], u_pairs [N_PAIRS, 2] -> (loss, has more than one
    segment)."""
    n = emb.shape[0]
    counts = torch.zeros(S_MAX, dtype=torch.float32, device=emb.device)
    counts = counts.index_add(0, labels, torch.ones_like(labels,
                                                         dtype=torch.float32))
    present = counts > 0
    with trace("sync.triplet_segments"):
        u = int(torch.sum(present))
    order = torch.argsort(labels, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    present_slots = torch.argsort((~present).to(torch.int32), stable=True)

    pos = (starts[:, None] + torch.floor(u_points * counts[:, None])).to(
        torch.int64)
    samples = emb[order[torch.clamp(pos, 0, n - 1)]]          # [S, P, D]

    ranks = torch.clamp((u_pairs * u).to(torch.int64), 0, max(u - 1, 0))
    k1, k2 = present_slots[ranks[:, 0]], present_slots[ranks[:, 1]]
    num_iter = min(N_PAIRS, u * u)
    pair_valid = ((k1 != k2) & (torch.arange(N_PAIRS, device=emb.device)
                                < num_iter)).to(torch.float32)

    e1, e2 = samples[k1], samples[k2]                        # [Q, P, D]
    diff_pos = torch.sum((e1[:, :, None, :] - e1[:, None, :, :]) ** 2, -1)
    diff_neg = torch.sum((e1[:, :, None, :] - e2[:, None, :, :]) ** 2, -1)
    constraint = torch.relu(diff_pos - diff_neg + margin)    # [Q, P, P]
    tr = torch.diagonal(constraint, dim1=1, dim2=2).sum(-1)
    raw = torch.sum(constraint, dim=(1, 2)) - tr
    satisfied = (torch.sum((constraint > 0).to(torch.float32), dim=(1, 2))
                 + 1.0).detach()
    per_pair = raw / satisfied
    loss = torch.sum(per_pair * pair_valid) / (torch.sum(pair_valid) + 1e-8)
    return loss, u > 1


def triplet_loss(embedding: torch.Tensor, labels: torch.Tensor,
                 u_points: torch.Tensor, u_pairs: torch.Tensor,
                 margin: float = 1.0, mesh=None) -> torch.Tensor:
    """Batch triplet loss. embedding [B, N, D] raw network output
    (normalised here), labels [B, N] int GT segment ids in [0, S_MAX),
    u_points / u_pairs the draws (module docstring) -> scalar.

    With a parallel.mesh.Mesh the batch is this rank's slice of a global
    one, and the normaliser, the count of multi-segment shapes, is the
    global batch's (summed over the ranks): the rank's loss is world x its
    shapes' share of the global loss, so the mean over the ranks (of the
    losses and of their gradients) is the one-rank loss of the global
    batch, however the multi-segment shapes fall among the ranks."""
    emb = embedding / (torch.linalg.norm(embedding, dim=-1, keepdim=True)
                       + 1e-12)
    losses, multi = [], []
    for b in range(emb.shape[0]):
        loss, m = _triplet_one_shape(emb[b], labels[b].to(torch.int64),
                                     u_points[b], u_pairs[b], margin)
        losses.append(loss)
        multi.append(float(m))
    with trace("sync.triplet_multi"):
        multi_f = torch.tensor(multi, dtype=torch.float32, device=emb.device)
    total, count = torch.sum(torch.stack(losses) * multi_f), torch.sum(multi_f)
    if mesh is not None:
        total, count = total * float(mesh.world), mesh.all_sum(count)
    return total / (count + 1e-8)


def primitive_nll_loss(prim_log_prob: torch.Tensor,
                       gt_prim: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the per-point type head (reference src/segment_loss.py:
    151-152). prim_log_prob [B, N, C], gt_prim [B, N] int -> scalar."""
    ll = torch.gather(prim_log_prob, -1, gt_prim.to(torch.int64)[..., None])
    return -torch.mean(ll)
