"""Linear assignment on the device.

Counterpart of parsenet_tpu/ops/hungarian.solve_lap: the cost matrix is
turned into an auction benefit (kernels.lap_benefit), the auction runs, and
any row still unassigned at the round cap is completed onto the leftover
columns by rank (kernels.complete_assignment), so the result is always a
permutation. On the card all three are one launch of K2 (kernels.lap_assign)
for a whole batch of matrices.

Benefit preparation (see the JAX module's notes):
- a column-linear tie-breaker LAP_TIE * j strictly orders otherwise identical
  columns; it shifts every perfect matching by the same constant;
- uniform rows (an empty predicted segment against every column) get a
  diagonal parking bonus LAP_BETA, so m identical rows park on m distinct
  columns in one round instead of fighting a price war.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .kernels import (complete_assignment, lap_assign,  # noqa: F401
                      lap_benefit)

_EPS0 = 1e-5      # initial bid increment; n * eps optimality slack
_ESC_EVERY = 150  # rounds between eps escalations
_ESC = 8.0        # eps escalation factor


def solve_lap(cost: torch.Tensor, max_iter: int = 3000) -> torch.Tensor:
    """Minimum-cost perfect matching of square cost matrices [n, n] or
    [B, n, n]. Returns col_of_row [n] / [B, n] int32, always a permutation.
    On the card the whole solve (benefit, auction, rank fill) is one K2
    launch for all B matrices; on the CPU it is kernels.lap_assign_plain."""
    return lap_assign(cost.to(torch.float32), _EPS0, _ESC_EVERY, _ESC,
                      max_iter)


def solve_lap_host(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The exact minimum-cost assignment on the host by scipy's
    linear_sum_assignment (drop-in for lapsolver.solve_dense): (row ids,
    column ids) int32."""
    from scipy.optimize import linear_sum_assignment
    rids, cids = linear_sum_assignment(np.asarray(cost))
    return rids.astype(np.int32), cids.astype(np.int32)
