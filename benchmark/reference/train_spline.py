"""The reference's steps of the closed SplineNet (ParSeNet's closed-spline
control-point decoder, arXiv:2003.12181; the reference code's
train_closed_control_points.py with configs/config_closed_splines.yml), in
float32 with TF32 off (reference.precision), built on the frozen plain
paths: models/splinenet.py in training mode, ops/bspline.py,
ops/chamfer.py (the plain min squared distance and its backward),
losses/spline.py and data/splines.py, and train.adam_run for Adam.

Every checked step's batch is made again from the seeds, as the trainer's
feed makes it: the pool's patches split and shuffled, each batch
PCA-aligned, scaled per axis and augmented (data/splines.train_batches),
and the step's point count drawn from the buckets by its own RandomState.

Departures from the reference paper's code, each the port's as well:
* the point count a step is one of 7 buckets, 448-1,984 (the port's
  POINT_BUCKETS), not 700 + U(-300, 1300) drawn a point at a time, so that
  a run meets 7 shapes; the patches are kept from their first points;
* BatchNorm keeps flax's statistics (biased variance, momentum 0.9) and
  the EdgeConvs take its moments by neighbour sums (EdgeConvBN), which is
  the same normalisation without the [B, N, k, C] edge tensor;
* the initialisation is flax's (init_flax_like), not torch's defaults;
* the validation pass and the per-epoch plateau schedule are left out:
  the steps run at the configuration's lr.
"""
from __future__ import annotations

import numpy as np
import torch

from .plain.data.splines import train_batches
from .plain.losses.spline import (control_points_permute_closed_reg_loss,
                                  spline_reconstruction_loss_one_sided)
from .plain.models.splinenet import SplineNet, init_flax_like
from .plain.ops.bspline import uniform_knot_bspline
from .train import adam_run


def rescale_outputs(scales: torch.Tensor, output: torch.Tensor,
                    points: torch.Tensor, cps: torch.Tensor):
    """Undo the anisotropic per-axis normalisation before the loss
    (reference: src/utils.py:361-390). scales: [B, 3]."""
    m = torch.amax(scales, dim=1)[:, None, None]
    output = output * scales[:, None, :] / m
    points = points * scales[:, None, :] / m
    cps = cps * scales[:, None, None, :] / m[..., None]
    return output, points, cps


def spline_loss(model, nu, nv, points, cps, scales, grid: int,
                loss_weight: float, anisotropic: bool) -> torch.Tensor:
    """The closed trainer's loss of one batch: w x the 80-symmetry
    regression + (1 - w) x the one-sided chamfer, no Laplacian."""
    out = model(points)
    if anisotropic:
        out, points, cps = rescale_outputs(scales, out, points, cps)
    cd, _ = spline_reconstruction_loss_one_sided(nu, nv, out, points)
    l_reg, _ = control_points_permute_closed_reg_loss(out, cps, grid)
    return l_reg * loss_weight + cd * (1.0 - loss_weight)


def step_batches(pool, batch: int, steps: int, data_seed: int,
                 bucket_seed: int, buckets, anisotropic: bool = True) -> list:
    """The first `steps` batches the trainer's feed gives: (points [B, n,
    3], cps, scales) numpy, n the step's bucket."""
    gen = train_batches(pool.points, pool.cps, batch, data_seed,
                        anisotropic=anisotropic)
    rng = np.random.RandomState(bucket_seed)
    out = []
    for _ in range(steps):
        points, cps, scales, _ = next(gen)
        n = min(buckets[rng.randint(len(buckets))], points.shape[1])
        out.append((points[:, :n], cps, scales))
    return out


def spline_steps(cfg: dict, batches: list, init_seed: int, dev,
                 half: bool = False) -> dict:
    """The closed SplineNet's steps on `batches` from flax's
    initialisation seeded init_seed. half: the planted fault of the
    check's readings, each step's loss (and BatchNorm's moments) taken
    over the first half of its patches."""
    net, tr = cfg["network"], cfg["training"]
    grid = net["grid"]
    model = SplineNet(grid=grid, k=net["k"], mode=net["mode"])
    init_flax_like(model, torch.Generator().manual_seed(init_seed))
    model.to(dev).train()
    nu, nv = (torch.as_tensor(b, device=dev) for b in uniform_knot_bspline(
        grid, grid, 3, 3, net["sample_grid"]))
    steps = []
    for points, cps, scales in batches:
        keep = points.shape[0] // 2 if half else points.shape[0]
        p, c, s = (torch.as_tensor(np.ascontiguousarray(a[:keep]),
                                   dtype=torch.float32, device=dev)
                   for a in (points, cps, scales))

        def loss_fn(p=p, c=c, s=s):
            return spline_loss(model, nu, nv, p, c, s, grid,
                               tr["loss_weight"], tr["anisotropic"])
        steps.append([loss_fn])
    return adam_run(model, steps, float(tr["lr"]))
