"""SplineNet trainer (open and closed control-point prediction).

Counterpart of parsenet_tpu/train/train_spline.py (reference
train_open_splines.py / train_closed_control_points.py): the DGCNN
control-point decoder trained with

    loss = w * permutation-reg + (1 - w) * (one-sided chamfer + laplacian)

(no laplacian for closed splines, reference train_closed_control_points.py:
173), Adam with a plateau lr on the validation chamfer, best-validation
weights saved as an npz in the flax layout of params/*.npz. The chamfer runs
through K3 forward and K4 backward. Each step draws its point count from
`point_buckets` ("robust to density", reference train_open_splines.py:152),
so shapes change from step to step; PyTorch runs eagerly and needs no
static shapes. `make_fed_step` is one step with its feed (the next batch,
the point count, the copies to the card), which the loop and the
benchmark call.

    python -m parsenet_tpu_torch.train.train_spline configs/config_open_splines.yml
    python -m parsenet_tpu_torch.train.train_spline configs/config_closed_splines.yml --closed

The entry reads the config's h5 as the JAX entry points do; callers with
other data pass their own generators to `run_training`.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..core.checkpoint import PlateauScheduler, save_npz_params
from ..core.config import Config, load_config
from ..core.logging import setup_logging, snapshot_config
from ..core.profiling import StageTimer, trace
from ..losses.spline import (control_points_permute_closed_reg_loss,
                             control_points_permute_reg_loss, laplacian_loss,
                             spline_reconstruction_loss,
                             spline_reconstruction_loss_one_sided)
from ..data.prefetch import lookahead
from ..models.splinenet import (SplineNet, init_flax_like, params_to_jax,
                                sync_batch_norm)
from ..ops.bspline import uniform_knot_bspline
from ..parallel.mesh import replicate, shard_batch
from .state import (make_optimizer, rank_logger, rank_mean, set_lr,
                    trainer_mesh)

log = logging.getLogger(__name__)

POINT_BUCKETS = (448, 704, 960, 1216, 1472, 1728, 1984)
# "loss" holds chamfer (K3; K4 runs in the backward), named as train_e2e
# names its own
STAGES = ("forward", "loss", "chamfer", "backward", "optimizer")
_NO_TIMER = StageTimer(False)


class TrainResult(NamedTuple):
    """What `run_training` returns: the trained model, each step's metrics
    ({loss, cd, l_reg, lap}) and each epoch's (their means, val_cd, lr)."""
    model: SplineNet
    steps: list
    epochs: list


def rescale_outputs(scales: torch.Tensor, output: torch.Tensor,
                    points: torch.Tensor, cps: torch.Tensor):
    """Undo the anisotropic per-axis normalisation before the loss
    (reference: src/utils.py:361-390). scales: [B, 3]."""
    m = torch.amax(scales, dim=1)[:, None, None]
    output = output * scales[:, None, :] / m
    points = points * scales[:, None, :] / m
    cps = cps * scales[:, None, None, :] / m[..., None]
    return output, points, cps


def make_train_step(model: SplineNet, optimizer: torch.optim.Optimizer,
                    nu: torch.Tensor, nv: torch.Tensor, grid: int,
                    closed: bool, anisotropic: bool, mesh=None):
    """(train_step, eval_step) over `model` and `optimizer`.

    train_step(points, cps, scales, lr, loss_weight, timer) runs one
    optimizer step in train mode (BatchNorm takes batch moments and updates
    its running statistics) and returns the step's {loss, cd, l_reg, lap},
    taken before the update. eval_step(points, cps, scales) returns the
    two-sided sqrt chamfer in eval mode.

    With a parallel.mesh.Mesh the batches are this rank's slices of global
    ones: BatchNorm takes the global batch's moments (models.splinenet.
    sync_batch_norm), the gradients are averaged over the ranks before the
    update and the metrics are the global batch's, so a step is the
    one-rank step of the global batch (each loss is a mean over shapes)."""
    sync_batch_norm(model, mesh)
    params = list(model.parameters())
    reg_fn = (control_points_permute_closed_reg_loss if closed
              else control_points_permute_reg_loss)

    def train_step(points, cps, scales, lr: float, loss_weight: float,
                   timer: StageTimer = _NO_TIMER):
        model.train()
        set_lr(optimizer, lr)
        with timer("forward"):
            out = model(points)
        with timer("loss"):
            if anisotropic:
                out_r, pts_r, cps_r = rescale_outputs(scales, out, points, cps)
            else:
                out_r, pts_r, cps_r = out, points, cps
            with timer("chamfer"):
                cd, _ = spline_reconstruction_loss_one_sided(nu, nv, out_r,
                                                             pts_r)
            l_reg, permuted = reg_fn(out_r, cps_r, grid)
            if closed:
                lap = torch.zeros((), dtype=out.dtype, device=out.device)
            else:
                lap = laplacian_loss(out_r.reshape(-1, grid, grid, 3),
                                     permuted)
            loss = l_reg * loss_weight + (cd + lap) * (1.0 - loss_weight)
        with timer("backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with timer("optimizer"):
            if mesh is not None:
                mesh.all_reduce_grads(params)
            optimizer.step()
        return rank_mean({"loss": loss.detach(), "cd": cd.detach(),
                          "l_reg": l_reg.detach(), "lap": lap.detach()}, mesh)

    @torch.no_grad()
    def eval_step(points, cps, scales):
        model.eval()
        out = model(points)
        if anisotropic:
            out, points, cps = rescale_outputs(scales, out, points, cps)
        cd, _ = spline_reconstruction_loss(nu, nv, out, points, sqrt=True)
        return cd if mesh is None else mesh.all_mean(cd)

    return train_step, eval_step


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """`a` as f32 on `dev`; a copy from the host's pageable memory to
    the card waits for the card's queue (span sync.h2d_input)."""
    a = np.ascontiguousarray(a, np.float32)
    if torch.device(dev).type == "cuda":
        with trace("sync.h2d_input"):
            return torch.as_tensor(a, device=dev)
    return torch.as_tensor(a, device=dev)


def make_fed_step(train_step, feed: Iterator,
                  host_rng: np.random.RandomState, point_buckets, dev,
                  mesh=None, drawn: Optional[list] = None):
    """One optimizer step with its feed: fed_step(lr, loss_weight,
    timer) takes the next batch of `feed` (numpy points, cps, scales,
    rotations), draws the step's point count from `point_buckets` by
    `host_rng` (capped at the batch's), keeps that many of each patch's
    points, copies the batch to `dev` (this rank's slice under a mesh) and
    runs train_step (`make_train_step`) -> the step's metrics; each
    step's point count is appended to `drawn` if one is given. The
    trainer's loop and the benchmark both call it. Spans: the step
    (entry.spline_train_step), the wait for the batch (feed.next) and each
    copy to the card (sync.h2d_input)."""
    def fed_step(lr: float, loss_weight: float,
                 timer: StageTimer = _NO_TIMER) -> dict:
        with trace("entry.spline_train_step"):
            with trace("feed.next"):
                points, cps, scales, _ = next(feed)
            npts = point_buckets[host_rng.randint(len(point_buckets))]
            npts = min(npts, points.shape[1])
            if drawn is not None:
                drawn.append(npts)
            batch = (_to(points[:, :npts], dev), _to(cps, dev),
                     _to(scales, dev))
            return train_step(*shard_batch(mesh, batch), lr, loss_weight,
                              timer)
    return fed_step


def make_trainer(config: Config, closed: bool, anisotropic: bool, dev,
                 mesh=None):
    """The trainer's network (mode 1 closed, 0 open; k 10) from flax's
    initialisers seeded config.seed, on `dev` (rank 0's weights under a
    mesh), its optimizer (config.optim at config.lr) and `make_train_step`'s
    steps over the 40 x 40 sample basis -> (model, optimizer, train_step,
    eval_step)."""
    grid = config.grid_size
    nu_np, nv_np = uniform_knot_bspline(grid, grid, 3, 3, 40)
    nu, nv = _to(nu_np, dev), _to(nv_np, dev)
    model = SplineNet(grid=grid, k=10, mode=1 if closed else 0)
    init_flax_like(model, torch.Generator().manual_seed(config.seed))
    model.to(dev)
    if mesh is not None:
        replicate(mesh, model)
    optimizer = make_optimizer(model.parameters(), config.optim, config.lr)
    train_step, eval_step = make_train_step(model, optimizer, nu, nv, grid,
                                            closed, anisotropic, mesh)
    return model, optimizer, train_step, eval_step


def run_training(config: Config, closed: bool = False,
                 train_gen: Optional[Iterator] = None,
                 val_gen: Optional[Iterator] = None,
                 steps_per_epoch: Optional[int] = None,
                 val_steps: int = 4,
                 anisotropic: bool = True,
                 point_buckets=POINT_BUCKETS,
                 checkpoint: bool = True,
                 device=None,
                 timer: StageTimer = _NO_TIMER, mesh=None) -> TrainResult:
    """The training loop. Generators yield numpy (points, cps, scales,
    rotations); without them the config's h5 is read
    (`data.splines.SplineDataset`). Each step's point count is a
    bucket drawn by RandomState(config.seed), capped at the batch's. With
    `checkpoint`, every epoch whose validation chamfer is the best so far
    writes {log_dir}/checkpoints/{model_path}.npz. device None = "cuda";
    `timer` splits each step into STAGES.

    Data parallel over config.num_devices ranks as train_seg.run_training
    (a caller's `mesh` instead): every rank reads the same global batches
    and point counts and keeps its slice of the batch axis; BatchNorm and
    the gradients are synchronised (make_train_step); rank 0 alone logs
    and writes the checkpoint."""
    mesh, dev, own_mesh = trainer_mesh(config, mesh, device)
    try:
        return _train(config, closed, train_gen, val_gen, steps_per_epoch,
                      val_steps, anisotropic, point_buckets, checkpoint, dev,
                      timer, mesh)
    finally:
        if own_mesh:
            mesh.close()


def _train(config, closed, train_gen, val_gen, steps_per_epoch, val_steps,
           anisotropic, point_buckets, checkpoint, dev, timer,
           mesh) -> TrainResult:
    from ..data.splines import SplineDataset

    grid = config.grid_size
    if train_gen is None:
        # the config's split sizes where they are below the reference's
        default_tr, default_val = (28000, 3000) if closed else (50000, 10000)
        splits = (min(config.num_train, default_tr) or default_tr,
                  min(config.num_val, default_val) or default_val)
        ds = SplineDataset(config.dataset, config.batch_size, grid,
                           closed=closed, seed=config.seed, splits=splits)
        train_gen = ds.load_train_data(anisotropic=anisotropic, if_augment=True)
        val_gen = ds.load_val_data(anisotropic=anisotropic)

    model, _, train_step, eval_step = make_trainer(config, closed,
                                                   anisotropic, dev, mesh)
    train_gen = lookahead(train_gen)
    sched = PlateauScheduler(config.lr, patience=10, factor=0.5, min_lr=3e-5)
    ckpt_path = (os.path.join(config.log_dir, "checkpoints",
                              f"{config.model_path}.npz")
                 if checkpoint else None)
    steps_per_epoch = steps_per_epoch or max(
        config.num_train // config.batch_size, 1)
    fed_step = make_fed_step(train_step, train_gen,
                             np.random.RandomState(config.seed),
                             point_buckets, dev, mesh)
    best_cd = float("inf")
    lr = config.lr
    mlog = rank_logger(mesh, config.log_dir, config.model_path)
    steps, epochs = [], []

    for epoch in range(config.num_epochs):
        t0 = time.time()
        tr_metrics = []
        for _ in range(steps_per_epoch):
            tr_metrics.append(fed_step(lr, config.loss_weight, timer))
        val_cds = []
        for _ in range(val_steps):
            points, cps, scales, _ = next(val_gen)
            n = min(point_buckets[-1], points.shape[1])
            val_cds.append(float(eval_step(*shard_batch(
                mesh, (_to(points[:, :n], dev), _to(cps, dev),
                       _to(scales, dev))))))
        val_cd = float(np.mean(val_cds))
        lr = sched.step(val_cd)
        step_floats = [{k: float(v) for k, v in m.items()}
                       for m in tr_metrics]
        steps += step_floats
        tr = {k: float(np.mean([m[k] for m in step_floats]))
              for k in step_floats[0]}
        if mesh.is_main:
            log.info("epoch %d loss %.5f cd %.5f reg %.5f val_cd %.5f lr "
                     "%.2e (%.1fs)", epoch, tr["loss"], tr["cd"], tr["l_reg"],
                     val_cd, lr, time.time() - t0)
        epochs.append({**tr, "val_cd": val_cd, "lr": lr})
        mlog.log(epoch, epochs[-1])
        if ckpt_path is not None and val_cd < best_cd:
            best_cd = val_cd
            if mesh.is_main:
                save_npz_params(ckpt_path, params_to_jax(model))
    mlog.close()
    return TrainResult(model, steps, epochs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Train the open (default) or closed SplineNet.")
    ap.add_argument("config", help="configs/config_{open,closed}_splines.yml")
    ap.add_argument("--closed", action="store_true",
                    help="closed (u-periodic) control grids, mode 1")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    name = "closed_splines" if args.closed else "open_splines"
    setup_logging(cfg.log_dir, name)
    snapshot_config(cfg, cfg.log_dir, name)
    run_training(cfg, closed=args.closed, device=args.device)


if __name__ == "__main__":
    main()
