"""Linear assignment on the device.

Counterpart of parsenet_tpu/ops/hungarian.solve_lap: the cost matrix is
turned into an auction benefit, the auction runs as K2, and any row still
unassigned at the round cap is completed onto the leftover columns by rank,
so the result is always a permutation.

Benefit preparation (see the JAX module's notes):
- a column-linear tie-breaker _TIE * j strictly orders otherwise identical
  columns; it shifts every perfect matching by the same constant;
- uniform rows (an empty predicted segment against every column) get a
  diagonal parking bonus _BETA, so m identical rows park on m distinct
  columns in one round instead of fighting a price war.
"""
from __future__ import annotations

import torch

from .kernels import auction_assign

_TIE = 1e-7       # column-linear tie-breaker slope (exactness-neutral)
_BETA = 2e-5      # diagonal parking bonus for uniform rows
_EPS0 = 1e-5      # initial bid increment; n * eps optimality slack
_ESC_EVERY = 150  # rounds between eps escalations
_ESC = 8.0        # eps escalation factor


def lap_benefit(cost: torch.Tensor) -> torch.Tensor:
    """Auction benefit of a cost matrix [..., n, n]."""
    n = cost.shape[-1]
    cost = cost.to(torch.float32)
    row_span = torch.amax(cost, dim=-1) - torch.amin(cost, dim=-1)
    uniform = (row_span <= 1e-6).to(torch.float32)
    tie = _TIE * torch.arange(n, dtype=torch.float32, device=cost.device)
    eye = torch.eye(n, dtype=torch.float32, device=cost.device)
    park = _BETA * uniform[..., :, None] * eye
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


def solve_lap(cost: torch.Tensor, max_iter: int = 3000) -> torch.Tensor:
    """Minimum-cost perfect matching of a square cost matrix [n, n].
    Returns col_of_row [n] int32, always a permutation."""
    assignment = auction_assign(lap_benefit(cost), _EPS0, _ESC_EVERY, _ESC,
                                max_iter)
    return complete_assignment(assignment)
