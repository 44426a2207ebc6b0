"""The plain versions of the port's kernels, for the benchmark's reference.

Frozen copies of the plain PyTorch versions in parsenet_tpu_torch/ops/
kernels.py (K1's `_ms_plain`, K2's `lap_assign_plain`, K3's
`min_sqdist_with_idx_plain`, K4's `min_sqdist_bwd_plain`) under the names
the copied modules import, on whatever device their inputs lie. No CUDA
source is built and nothing is launched.

`MS_LOW` is the type K1's bf16 mode rounds its product operands to
(bfloat16); the benchmark's lower-precision control sets float8 here
(reference.precision).
"""
from __future__ import annotations

from typing import Optional

import torch

MS_BLOCK_ROWS = 128
MS_LOW = {"dtype": torch.bfloat16}
AUCTION_NEG = -1e9
AUCTION_ROUNDS = 512
LAP_TIE = 1e-7
LAP_BETA = 2e-5
LAP_UNIFORM = 1e-6
MIN_SQDIST_BIG = 1e30
PLAIN_QUERY_CHUNK = 8192


def _inv2b2(bandwidth, device) -> torch.Tensor:
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=device)
    return (1.0 / (2.0 * bw * bw)).reshape(1)


def _ms_plain(X, bandwidth, iterations, bf16_dots, tol, exit_rows):
    """(m, iterations run per group, deltas): the JAX rule per group, delta
    = inf, while it < iterations and delta > tol: delta = max |new_m - m|
    over the group's rows and m = new_m. deltas [iterations run, groups]:
    each group's delta at each iteration, NaN once it has left (empty at
    tol = 0)."""
    inv2b2 = _inv2b2(bandwidth, X.device)
    low = MS_LOW["dtype"]
    rnd = ((lambda t: t.to(low).to(torch.float32)) if bf16_dots
           else (lambda t: t))
    xd = rnd(X)
    n = X.shape[0]
    group = torch.arange(n, device=X.device) // exit_rows
    active = torch.ones(-(-n // exit_rows), dtype=torch.bool, device=X.device)
    counts = torch.zeros(active.shape, dtype=torch.int64, device=X.device)
    deltas = []
    m = X
    for _ in range(iterations):
        if tol > 0.0 and not bool(active.any()):
            break
        s = rnd(m) @ xd.T
        k = torch.exp((2.0 * s - 2.0) * inv2b2)
        new_m = (rnd(k) @ xd) / (torch.sum(k, dim=1, keepdim=True) + 1e-12)
        new_m = new_m / (torch.linalg.norm(new_m, dim=1, keepdim=True)
                         + 1e-12)
        counts += active
        if tol > 0.0:
            delta = torch.zeros(active.shape, dtype=X.dtype,
                                device=X.device).scatter_reduce(
                0, group, torch.amax(torch.abs(new_m - m), dim=1), "amax")
            m = torch.where(active[group][:, None], new_m, m)
            deltas.append(torch.where(active, delta, float("nan")))
            active = active & (delta > tol)
        else:
            m = new_m
    return m, counts, (torch.stack(deltas) if deltas else
                       torch.empty((0, active.shape[0]), device=X.device))


def mean_shift_iterations(X: torch.Tensor, bandwidth, iterations: int,
                          bf16_dots: bool = False,
                          tol: float = 0.0) -> torch.Tensor:
    """K1's plain version: `iterations` gaussian mean-shift steps of X
    [N, D], each 128-row block stopping early where tol > 0."""
    return _ms_plain(X, bandwidth, iterations, bf16_dots, tol,
                     MS_BLOCK_ROWS)[0]


def lap_benefit(cost: torch.Tensor) -> torch.Tensor:
    """Auction benefit of a cost matrix [..., n, n]: -(cost + LAP_TIE j),
    plus LAP_BETA on the diagonal of uniform rows (see ops/hungarian.py)."""
    n = cost.shape[-1]
    cost = cost.to(torch.float32)
    row_span = torch.amax(cost, dim=-1) - torch.amin(cost, dim=-1)
    uniform = (row_span <= LAP_UNIFORM).to(torch.float32)
    tie = LAP_TIE * torch.arange(n, dtype=torch.float32, device=cost.device)
    eye = torch.eye(n, dtype=torch.float32, device=cost.device)
    park = LAP_BETA * uniform[..., :, None] * eye
    return -(cost + tie) + park


def complete_assignment(assignment: torch.Tensor) -> torch.Tensor:
    """Rows with -1 take the leftover columns, r-th such row -> r-th free
    column. assignment [n] int -> permutation [n] int32."""
    n = assignment.shape[-1]
    a = assignment.to(torch.int64)
    assigned = a >= 0
    col_taken = torch.zeros(n + 1, dtype=torch.bool, device=a.device)
    col_taken[torch.where(assigned, a, n)] = True
    ar = torch.arange(n, device=a.device)
    free_cols = torch.sort(torch.where(col_taken[:n], n, ar)).values
    fill_rank = torch.cumsum((~assigned).to(torch.int64), dim=0) - 1
    fill = free_cols[torch.clamp(fill_rank, 0, n - 1)]
    return torch.where(assigned, a, fill).to(torch.int32)


def _pad_benefit(benefit: torch.Tensor) -> torch.Tensor:
    """[B, n, n] -> [B, n_pad, n_pad], n_pad = max(8, ceil8(n)): padding
    entries -1e6, padding persons parked on their own padding object (+1)."""
    b, n, _ = benefit.shape
    n_pad = max(8, -(-n // 8) * 8)
    out = torch.full((b, n_pad, n_pad), -1e6, dtype=torch.float32,
                     device=benefit.device)
    out[:, :n, :n] = benefit
    torch.diagonal(out, dim1=1, dim2=2)[:, n:].fill_(-1e6 + 1.0)
    return out


def auction_assign_plain(benefit: torch.Tensor, eps0: float, esc_every: int,
                         esc: float, max_iter: int) -> torch.Tensor:
    """The TPU kernel's forward auction in PyTorch ops. benefit [n, n] or
    [B, n, n] -> obj_of_person [n] / [B, n] int32 (-1 on bailout). Stops
    once every person is assigned: later rounds are provable no-ops."""
    squeeze = benefit.dim() == 2
    bp = _pad_benefit(benefit[None] if squeeze else benefit)
    b, n, _ = bp.shape
    dev = bp.device
    neg = torch.tensor(AUCTION_NEG, dtype=torch.float32, device=dev)
    col = torch.arange(n, device=dev)
    obj = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    prices = torch.zeros((b, n), dtype=torch.float32, device=dev)
    eps = torch.tensor(eps0, dtype=torch.float32, device=dev)
    esc_t = torch.tensor(esc, dtype=torch.float32, device=dev)
    for it in range(min(int(max_iter), AUCTION_ROUNDS)):
        unas = obj < 0
        if not bool(unas.any()):
            break
        vals = bp - prices[:, None, :]
        a1 = torch.argmax(vals, dim=2)
        m1 = torch.gather(vals, 2, a1[..., None])[..., 0]
        oh = col[None, None, :] == a1[..., None]
        m2 = torch.amax(torch.where(oh, vals - 2.0 * abs(AUCTION_NEG), vals),
                        dim=2)
        price_a1 = torch.gather(prices, 1, a1)
        bid = torch.where(unas, price_a1 + (m1 - m2) + eps, neg)
        bid_mat = torch.where(oh, bid[..., None], neg)       # [B, person, obj]
        obj_best = torch.amax(bid_mat, dim=1)
        winner = torch.argmax(bid_mat, dim=1)
        got_bid = obj_best > AUCTION_NEG / 2
        own = obj.clamp(min=0)
        evicted = ((obj >= 0) & torch.gather(got_bid, 1, own)
                   & (torch.gather(winner, 1, own) != col[None, :]))
        obj = torch.where(evicted, -1, obj)
        win = unas & (torch.gather(winner, 1, a1) == col[None, :])
        obj = torch.where(win, a1, obj)
        prices = torch.where(got_bid, obj_best, prices)
        if (it + 1) % int(esc_every) == 0:
            eps = eps * esc_t
    out = obj[:, :benefit.shape[-1]].to(torch.int32)
    return out[0] if squeeze else out


def lap_assign_plain(cost: torch.Tensor, eps0: float, esc_every: int,
                     esc: float, max_iter: int) -> torch.Tensor:
    """solve_lap in PyTorch ops: lap_benefit, auction_assign_plain and
    complete_assignment of each matrix. cost [n, n] or [B, n, n] ->
    col_of_row [n] / [B, n] int32, each a permutation."""
    squeeze = cost.dim() == 2
    c3 = cost[None] if squeeze else cost
    a = auction_assign_plain(lap_benefit(c3), eps0, esc_every, esc, max_iter)
    out = torch.stack([complete_assignment(row) for row in a])
    return out[0] if squeeze else out


def lap_assign(cost: torch.Tensor, eps0: float, esc_every: int, esc: float,
               max_iter: int) -> torch.Tensor:
    """K2's plain version (`lap_assign_plain`)."""
    return lap_assign_plain(cost, eps0, esc_every, esc, max_iter)


def _penalty(x: torch.Tensor, x_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if x_mask is None:
        return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    return torch.where(x_mask > 0, 0.0, MIN_SQDIST_BIG).to(torch.float32)


def _as_batch(q, x, x_mask):
    """2-d inputs -> a batch of one: (q3, x3, mask3, squeeze)."""
    if q.dim() == 2:
        return (q[None], x[None], None if x_mask is None else x_mask[None],
                True)
    return q, x, x_mask, False


def min_sqdist_with_idx_plain(q: torch.Tensor, x: torch.Tensor,
                              x_mask: Optional[torch.Tensor] = None):
    """Per query of q [N, 3] (or [B, N, 3]): (min_j (qq - 2 q.x_j + xx_j) +
    pen_j, first argmin) over x [M, 3] (or patch b's x [B, M, 3]); masked
    targets get +1e30. -> ([N] f32, [N] int32), or [B, N] each."""
    q, x, x_mask, squeeze = _as_batch(q, x, x_mask)
    pen = _penalty(x, x_mask)                                 # [B, M]
    xx = torch.sum(x * x, dim=2)
    xt = x.transpose(1, 2)
    dists, idxs = [], []
    for s in range(0, q.shape[1], PLAIN_QUERY_CHUNK):
        qc = q[:, s:s + PLAIN_QUERY_CHUNK]
        qq = torch.sum(qc * qc, dim=2, keepdim=True)
        d = (qq - 2.0 * (qc @ xt)) + xx[:, None, :] + pen[:, None, :]
        i = torch.argmin(d, dim=2)
        dists.append(torch.gather(d, 2, i[..., None])[..., 0])
        idxs.append(i)
    d = torch.clamp(torch.cat(dists, 1), max=MIN_SQDIST_BIG)
    i = torch.clamp(torch.cat(idxs, 1), 0, x.shape[1] - 1).to(torch.int32)
    return (d[0], i[0]) if squeeze else (d, i)


def min_sqdist_with_idx(q: torch.Tensor, x: torch.Tensor,
                        x_mask: Optional[torch.Tensor] = None):
    """K3's plain version (`min_sqdist_with_idx_plain`)."""
    return min_sqdist_with_idx_plain(q, x, x_mask)


def ordered_scatter_sub(rows: torch.Tensor, vals: torch.Tensor,
                        size: int) -> torch.Tensor:
    """out[r] = ((0 - vals[i1]) - vals[i2]) - ... over the i with rows[i] ==
    r, in ascending i: a scatter of -vals whose sum order is fixed, the same
    on every device and in every run. rows [Q] int, vals [Q, C] ->
    [size, C]. One masked update per rank within a row (a stable sort gives
    the ranks), so the loop runs as often as the most-picked row is picked."""
    out = torch.zeros((size, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    if rows.numel() == 0:
        return out
    r, order = torch.sort(rows, stable=True)
    v = vals[order]
    pos = torch.arange(r.numel(), device=r.device)
    first = torch.ones_like(r, dtype=torch.bool)
    first[1:] = r[1:] != r[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        out[r[sel]] = out[r[sel]] - v[sel]
    return out


def min_sqdist_bwd_plain(q: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                         g: torch.Tensor):
    """dq = 2 (q - x[idx]) g, dx = scatter of -dq at idx summed in ascending
    query order (`ordered_scatter_sub`), as K4 sums it. q [B, N, 3], x [B, M,
    3], idx, g [B, N] -> (dq, dx)."""
    b, m = x.shape[0], x.shape[1]
    rows = (idx.long() + m * torch.arange(b, device=x.device)[:, None])
    xa = x.reshape(b * m, 3)[rows.reshape(-1)].reshape(q.shape)
    dq = 2.0 * (q - xa) * g[..., None]
    dx = ordered_scatter_sub(rows.reshape(-1), dq.reshape(-1, 3), b * m)
    return dq, dx.reshape(x.shape)


class MinSqdist(torch.autograd.Function):
    """Differentiable min squared distance: the plain K3 forward (saving q,
    x and the argmin), the plain K4 backward, the subgradient through the
    argmin. q [B, N, 3], x [B, M, 3], optional x_mask [B, M] -> [B, N]."""

    @staticmethod
    def forward(ctx, q, x, x_mask=None):
        d, idx = min_sqdist_with_idx_plain(q, x, x_mask)
        ctx.save_for_backward(q, x, idx)
        return d

    @staticmethod
    def backward(ctx, g):
        q, x, idx = ctx.saved_tensors
        dq, dx = min_sqdist_bwd_plain(q, x, idx, g.contiguous())
        return (dq if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None, None)
