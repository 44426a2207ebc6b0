"""ParSeNet segmentation trainer.

Counterpart of parsenet_tpu/train/train_seg.py (reference
train_parsenet.py): the DGCNN PrimitivesEmbedding trained with the triplet
embedding loss and the primitive NLL, Adam with a plateau lr on the
validation embedding loss, gradient accumulation over micro-batches, a
random point subsample a step (10,000 -> 7,000), the best-validation
weights saved as an npz in the flax layout of params/parsenet_e2e.npz with
the optimizer state and step beside it (`preload_model` resumes from
them), and the type head's mIoU.

    python -m parsenet_tpu_torch.train.train_seg configs/config_parsenet_normals.yml

The entry reads the config's h5 splits ({dataset}{train,val,test}_data.h5)
and fails without them; callers with other data pass their own generators
to `run_training`. The triplet draws come from a torch.Generator; the step
functions take them as arguments. Config.half_precision trains the bf16
network (train.state.network_kwargs).
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..core.checkpoint import (PlateauScheduler, load_train_state,
                               save_train_state)
from ..core.config import Config, load_config
from ..core.logging import setup_logging, snapshot_config
from ..core.profiling import StageTimer
from ..losses.embedding import draw_triplet, primitive_nll_loss, triplet_loss
from ..models.dgcnn import (PrimitivesEmbedding, init_flax_like,
                            params_from_jax, params_to_jax)
from ..ops.segmentation import mean_iou_per_class
from ..data.prefetch import lookahead
from ..parallel.mesh import replicate, shard_batch
from .state import (NO_TIMER, TrainResult, accumulated_step, make_optimizer,
                    mean_metrics, network_kwargs, pack_batch, rank_logger,
                    rank_mean, trainer_mesh, validation_batches,
                    validation_sample)

log = logging.getLogger(__name__)

STAGES = ("forward", "backward", "optimizer")
METRICS = ("embed_loss", "prim_loss", "miou")


def make_step_fns(model: PrimitivesEmbedding,
                  optimizer: torch.optim.Optimizer, mesh=None):
    """(train_step, eval_step) over `model` and `optimizer`.

    train_step(points [A, B, N, C], labels [A, B, N], prim [A, B, N],
    u_points [A, B, S_MAX, P], u_pairs [A, B, N_PAIRS, 2], lr, timer)
    accumulates the gradients of the A micro-batches, averages them, zeroes
    them all where any entry is not finite (the optimizer still steps) and
    takes one step; it returns the micro-batches' mean metrics and grad_ok.
    eval_step(points [B, N, C], labels, prim, u_points, u_pairs) returns the
    metrics without gradient. With a parallel.mesh.Mesh the batches are
    this rank's slices of global ones, and both return the global batch's
    metrics (train.state.accumulated_step)."""
    params = list(model.parameters())

    def loss_fn(points, labels, prim, u_points, u_pairs):
        emb, prim_logp = model(points)
        e_loss = triplet_loss(emb, labels, u_points, u_pairs, mesh=mesh)
        p_loss = primitive_nll_loss(prim_logp, prim)
        return e_loss + p_loss, {
            "embed_loss": e_loss, "prim_loss": p_loss,
            "miou": mean_iou_per_class(prim, prim_logp.detach())}

    def train_step(points, labels, prim, u_points, u_pairs, lr: float,
                   timer: StageTimer = NO_TIMER):
        def micro(a):
            with timer("forward"):
                return loss_fn(points[a], labels[a], prim[a], u_points[a],
                               u_pairs[a])
        return accumulated_step(optimizer, params, micro, points.shape[0],
                                METRICS, lr, timer, mesh)

    @torch.no_grad()
    def eval_step(points, labels, prim, u_points, u_pairs):
        return rank_mean(loss_fn(points, labels, prim, u_points, u_pairs)[1],
                         mesh)

    return train_step, eval_step


def run_training(config: Config, train_gen: Optional[Iterator] = None,
                 val_gen: Optional[Iterator] = None,
                 steps_per_epoch: Optional[int] = None, val_steps: int = 4,
                 points_per_shape: int = 7000,
                 val_shapes: Optional[int] = 32,
                 checkpoint: bool = True, device=None,
                 timer: StageTimer = NO_TIMER, mesh=None) -> TrainResult:
    """The training loop. Generators yield numpy (points [B, N, 3], labels
    [B, N], normals, prim); the training one B = batch_size x accum
    shapes. Without them the config's h5 splits are read (data.abc
    .ABCDataset). val_shapes: the size of the FIXED validation sample (the
    same shapes, point subsample and triplet draws every epoch) that
    scores epochs for the plateau lr and the best-weights save; None takes
    `val_steps` batches of val_gen as that sample instead
    (parsenet_tpu/train/train_seg.py:171-172). With
    `checkpoint`, every epoch whose validation embedding loss is the best
    so far writes {log_dir}/checkpoints/{model_path}.npz and the optimizer
    state beside it; preload_model resumes from them. device None =
    "cuda"; `timer` splits each step into STAGES. Returns a TrainResult
    whose epochs hold the means, val_embed_loss and lr.

    Data parallel over config.num_devices ranks (parallel.mesh.make_mesh;
    a caller's `mesh` instead): every rank reads the same global batches
    and draws, keeps its slice of the batch axis and averages gradients
    and metrics over the ranks, so a step equals the one-rank step of the
    global batch; rank 0 alone logs and writes checkpoints. The training
    generator runs behind data.prefetch.lookahead."""
    mesh, dev, own_mesh = trainer_mesh(config, mesh, device)
    try:
        return _train(config, train_gen, val_gen, steps_per_epoch, val_steps,
                      points_per_shape, val_shapes, checkpoint, dev, timer,
                      mesh)
    finally:
        if own_mesh:
            mesh.close()


def _train(config, train_gen, val_gen, steps_per_epoch, val_steps,
           points_per_shape, val_shapes, checkpoint, dev, timer,
           mesh) -> TrainResult:
    from ..data.abc import ABCDataset

    num_accum = max(config.accum, 1)
    with_normals = config.mode == 5
    if train_gen is None:
        ds = ABCDataset(config.batch_size * num_accum,
                        path_prefix=config.dataset or "data/shapes/",
                        train_size=config.num_train or None,
                        val_size=config.num_val or None,
                        test_size=config.num_test or None)
        train_gen = ds.get_train(if_normal_noise=with_normals)
        val_gen = ds.get_val(if_normal_noise=with_normals,
                             batch_size=config.batch_size)

    model = PrimitivesEmbedding(emb_size=128, num_primitives=10,
                                mode=5 if with_normals else 0,
                                k=config.knn_k, **network_kwargs(config))
    init_flax_like(model, torch.Generator().manual_seed(config.seed))
    model.to(dev)
    train_gen = lookahead(train_gen)
    optimizer = make_optimizer(model.parameters(), config.optim, config.lr,
                               config.weight_decay)
    ckpt_path = os.path.join(config.log_dir, "checkpoints",
                             f"{config.model_path}.npz")
    step = 0
    if config.preload_model:
        restored = load_train_state(ckpt_path)
        if restored is not None:
            flat, opt_state, step = restored
            model.load_state_dict(params_from_jax(flat, model))
            optimizer.load_state_dict(opt_state)
            if mesh.is_main:
                log.info("resumed from step %d", step)
    replicate(mesh, model)
    train_step, eval_step = make_step_fns(model, optimizer, mesh)
    sched = PlateauScheduler(config.lr, patience=config.patience, factor=0.5)
    steps_per_epoch = steps_per_epoch or max(
        config.num_train // (config.batch_size * num_accum), 1)
    host_rng = np.random.RandomState(config.seed + 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed + 2)
    best = float("inf")
    lr = config.lr
    mlog = rank_logger(mesh, config.log_dir, config.model_path)

    def pack(points, labels, normals, prim, rng):
        return pack_batch(points, labels, normals, prim, rng,
                          points_per_shape, with_normals, dev)

    n_val = (validation_batches(val_shapes, config.batch_size) if val_shapes
             else val_steps)
    val_batches = [shard_batch(mesh, vb) for vb in validation_sample(
        val_gen, n_val, config.seed, pack,
        lambda x, g: draw_triplet(x.shape[0], g, dev), dev)]

    steps, epochs = [], []
    for epoch in range(config.num_epochs):
        t0 = time.time()
        agg = []
        for _ in range(steps_per_epoch):
            micro = (num_accum, config.batch_size)
            batch = (*pack(*next(train_gen), host_rng),
                     *draw_triplet(num_accum * config.batch_size, gen, dev))
            agg.append(train_step(*(
                shard_batch(mesh, t.reshape(*micro, *t.shape[1:]), axis=1)
                for t in batch), lr, timer))
            step += 1
        val_emb = mean_metrics([eval_step(*vb)
                                for vb in val_batches])[1]["embed_loss"]
        lr = sched.step(val_emb)
        step_floats, tr = mean_metrics(agg)
        steps += step_floats
        if mesh.is_main:
            log.info("epoch %d embed %.4f prim %.4f miou %.3f | val embed "
                     "%.4f lr %.2e (%.1fs)", epoch, tr["embed_loss"],
                     tr["prim_loss"], tr["miou"], val_emb, lr,
                     time.time() - t0)
        epochs.append({**tr, "val_embed_loss": val_emb, "lr": lr})
        mlog.log(epoch, epochs[-1])
        improved = val_emb < best
        if improved:
            best = val_emb
        if checkpoint and improved and mesh.is_main:
            save_train_state(ckpt_path, params_to_jax(model),
                             optimizer.state_dict(), step)
    mlog.close()
    return TrainResult(model, steps, epochs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Train the ParSeNet segmentation network.")
    ap.add_argument("config", help="configs/config_parsenet*.yml")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    setup_logging(cfg.log_dir, cfg.model_path)
    snapshot_config(cfg, cfg.log_dir, cfg.model_path)
    run_training(cfg, device=args.device)


if __name__ == "__main__":
    main()
