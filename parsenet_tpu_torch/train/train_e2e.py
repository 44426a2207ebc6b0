"""End-to-end ParSeNet trainer: segmentation plus the differentiable
fitting loss.

Counterpart of parsenet_tpu/train/train_e2e.py (reference
train_parsenet_e2e.py): the pretrained segmentation network fine-tuned
with the residual fitting loss (fitting.pipeline.fitting_loss_shape),
which flows through mean-shift, the membership weights, the closed-form
fits and the FROZEN SplineNet decoders (reference residual_utils.py:50-66),
plus the triplet and NLL losses; batch 1 with 5-step gradient accumulation
on 8,000 points as the reference runs it. Non-finite gradients are zeroed
and Adam still steps (the JAX package's guard). On the card the step runs
K1 f32 (the escalation attempts), K2 (matching and the SIOU metric), K3
and K4 (the spline slots' chamfer).

    python -m parsenet_tpu_torch.train.train_e2e configs/config_parsenet_e2e.yml

The entry reads the config's h5 splits and fails without them; callers
with other data pass their own generators to `run_training`. It starts
from {log_dir}/checkpoints/{pretrain_model_path}.npz where that exists, and
takes its decoders from {log_dir}/checkpoints/{open,closed}_splinenet.npz,
else from the committed params/. Exact kNN throughout: the JAX package's
FAST_KNN_RECALL is an approx_max_k setting, which the port does not have.
Config.half_precision trains the bf16 network (train.state.network_kwargs).
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..core.checkpoint import load_npz_params, save_npz_params
from ..core.config import Config, load_config
from ..core.logging import setup_logging, snapshot_config
from ..core.profiling import StageTimer, trace
from ..fitting.pipeline import ABLATE_ARMS as FIT_ARMS
from ..fitting.pipeline import FittingLossOut, fitting_loss_shape
from ..fitting.spline_apply import trained_spline_fit
from ..losses.embedding import draw_triplet, primitive_nll_loss, triplet_loss
from ..models.dgcnn import (PrimitivesEmbedding, init_flax_like,
                            params_from_jax, params_to_jax)
from ..data.prefetch import lookahead
from ..parallel.mesh import replicate, shard_batch
from .state import (NO_TIMER, TrainResult, accumulated_step, make_optimizer,
                    mean_metrics, network_kwargs, pack_batch, rank_logger,
                    rank_mean, trainer_mesh, validation_batches,
                    validation_sample)

log = logging.getLogger(__name__)

# Config.fast_step's bundle: strided residual / spline / SIOU evaluation
# and 2-iteration escalation attempts
FAST_STEP_KNOBS = dict(spline_stride=4, residual_stride=2, siou_stride=2,
                       ms_attempt_iterations=2)
STAGES = ("dgcnn_forward", "embed_losses", "mean_shift", "matching", "fits",
          "spline", "chamfer", "backward", "optimizer")
MS_NUM_SAMPLES = 2048   # the mean-shift bandwidth subset (reference)
SAVE_EVERY = 2000       # optimizer steps between periodic saves
METRICS = ("embed_loss", "prim_loss", "res_loss", "geom_loss", "spline_loss",
           "seg_iou", "prim_iou", "clusters")
# make_e2e_step's stage-costing arms: netgrad (the network's outputs
# detached: the fitting loss's backward still runs down to them, the
# network's does not) and fit (no fitting loss), plus fitting_loss_shape's
ABLATE_ARMS = ("netgrad", "fit") + FIT_ARMS


class E2EDraws(NamedTuple):
    """One micro-batch's random draws: the triplet uniforms u_points
    [B, S_MAX, P_SAMPLES] and u_pairs [B, N_PAIRS, 2], and each shape's
    mean-shift subset [B, S] (row indices, S = min(ms_num_samples, N)),
    None where S = N."""
    u_points: torch.Tensor
    u_pairs: torch.Tensor
    subset: Optional[torch.Tensor]


def draw_e2e(batch: int, n: int, ms_num_samples: int,
             generator: Optional[torch.Generator] = None,
             device=None) -> E2EDraws:
    """A micro-batch's E2EDraws from `generator`."""
    u_points, u_pairs = draw_triplet(batch, generator, device)
    s = min(ms_num_samples, n)
    subset = (torch.stack([torch.randperm(n, generator=generator,
                                          device=device)[:s]
                           for _ in range(batch)]) if s < n else None)
    return E2EDraws(u_points, u_pairs, subset)


def make_e2e_step(model: PrimitivesEmbedding, spline_fit,
                  optimizer: torch.optim.Optimizer, quantile: float = 0.025,
                  iterations: int = 5, lamb: float = 0.1,
                  ms_num_samples: int = MS_NUM_SAMPLES,
                  with_normals: bool = True,
                  spline_stride: int = 2, residual_stride: int = 1,
                  siou_stride: int = 1,
                  ms_attempt_iterations: Optional[int] = None,
                  ablate=(), mesh=None):
    """(train_step, eval_step) over `model`, the frozen `spline_fit`
    (fitting.spline_apply.SplineFit) and `optimizer`.

    train_step(x [A, B, N, C], labels [A, B, N], prim [A, B, N], draws (A
    E2EDraws), lr, timer) accumulates the gradients of the A micro-batches
    (the reference loops .backward() five times), averages them, zeroes
    them all where any entry is not finite and still takes the optimizer
    step; it returns the mean metrics and grad_ok. eval_step(x [B, N, C],
    labels, prim, draws) returns one batch's metrics without gradient (its
    accepted mean-shift re-run on K1 f32). The strides and
    ms_attempt_iterations are fitting_loss_shape's. ablate: a subset of
    ABLATE_ARMS, for cli.bench_train only. With a parallel.mesh.Mesh the
    batches and draws are this rank's slices of global ones and both
    return the global batch's metrics (train.state.accumulated_step; every
    e2e metric but the triplet loss is a mean over shapes)."""
    bad = set(ablate) - set(ABLATE_ARMS)
    if bad:
        raise ValueError(f"make_e2e_step: ablate {sorted(bad)} not in "
                         f"{ABLATE_ARMS}")
    params = list(model.parameters())
    fit_kw = dict(spline_fit=spline_fit, quantile=quantile,
                  iterations=iterations, lamb=lamb,
                  ms_num_samples=ms_num_samples, spline_stride=spline_stride,
                  residual_stride=residual_stride, siou_stride=siou_stride,
                  ms_attempt_iterations=ms_attempt_iterations,
                  ablate=tuple(a for a in ablate if a in FIT_ARMS))

    def fitting(points, normals, emb, labels, prim, pred_prim, draws,
                timer):
        if "fit" in ablate:
            z = torch.zeros((), device=emb.device)
            return [FittingLossOut(z + torch.mean(emb) * 0.0, z, z, z, z, 0)
                    for _ in range(emb.shape[0])]
        return [fitting_loss_shape(
            points[b], normals[b], emb[b], labels[b], prim[b],
            subset=None if draws.subset is None else draws.subset[b],
            pred_prim_per_point=pred_prim[b], timer=timer, **fit_kw)
            for b in range(emb.shape[0])]

    def loss_fn(x, labels, prim, draws: E2EDraws, timer):
        with timer("dgcnn_forward"):
            emb, prim_logp = model(x)
            if "netgrad" in ablate:
                emb = emb.detach().requires_grad_()
                prim_logp = prim_logp.detach().requires_grad_()
        with timer("embed_losses"):
            e_loss = triplet_loss(emb, labels, draws.u_points, draws.u_pairs,
                                  mesh=mesh)
            p_loss = primitive_nll_loss(prim_logp, prim)
            pred_prim = torch.argmax(prim_logp, dim=-1)
        points = x[..., :3]
        normals = x[..., 3:6] if with_normals else points
        outs = fitting(points, normals, emb, labels, prim, pred_prim, draws,
                       timer)
        res_loss = torch.mean(torch.stack([o.loss for o in outs]))
        metrics = {"embed_loss": e_loss, "prim_loss": p_loss,
                   "res_loss": res_loss}
        for k in ("geom_loss", "spline_loss", "seg_iou", "prim_iou"):
            metrics[k] = torch.mean(torch.stack([getattr(o, k)
                                                 for o in outs]))
        with trace("sync.clusters_metric"):
            metrics["clusters"] = torch.tensor(
                float(np.mean([o.num_clusters for o in outs])),
                dtype=torch.float32, device=x.device)
        return e_loss + p_loss + res_loss, metrics

    def train_step(x, labels, prim, draws, lr: float,
                   timer: StageTimer = NO_TIMER):
        with trace("entry.e2e_train_step"):
            return accumulated_step(
                optimizer, params,
                lambda a: loss_fn(x[a], labels[a], prim[a], draws[a], timer),
                x.shape[0], METRICS, lr, timer, mesh)

    @torch.no_grad()
    def eval_step(x, labels, prim, draws):
        return rank_mean(loss_fn(x, labels, prim, draws, NO_TIMER)[1], mesh)

    return train_step, eval_step


def run_training(config: Config, train_gen: Optional[Iterator] = None,
                 val_gen: Optional[Iterator] = None,
                 steps_per_epoch: Optional[int] = None, val_steps: int = 2,
                 points_per_shape: int = 8000,
                 pretrained: Optional[dict] = None, spline_fit=None,
                 lamb: float = 0.1, val_shapes: Optional[int] = 16,
                 val_points: Optional[int] = None,
                 checkpoint: bool = True, device=None,
                 timer: StageTimer = NO_TIMER, mesh=None) -> TrainResult:
    """The fine-tuning loop. Generators yield numpy (points [B, N, 3],
    labels, normals, prim), the training one B = batch_size x accum
    shapes; without them the config's h5 splits are read (data.abc
    .ABCDataset). pretrained: flat flax weights to start from (else
    {log_dir}/checkpoints/{pretrain_model_path}.npz where it exists, else
    the seeded initialisation). spline_fit: the frozen decoders (else
    build_spline_fit, see the module docstring). val_shapes: the FIXED
    validation sample (the same shapes, points and draws every epoch)
    whose seg IoU picks the weights to save, its points drawn at
    val_points (None: points_per_shape; pass 10000 to select at the scale
    the shipping gate measures, as cli.finetune_e2e does). val_shapes
    None: each epoch scores `val_steps` streaming batches of val_gen
    instead, subsampled and drawn from the training streams, and the
    weights are saved every epoch. With `checkpoint`, each epoch that
    improves the fixed sample's seg IoU writes {log_dir}/checkpoints/
    {model_path}.npz, and every SAVE_EVERY optimizer steps
    {model_path}_step{step}.npz is written beside it (train_e2e.py:353 of
    the JAX package). device None = "cuda"; `timer` splits each step into
    STAGES. Returns a TrainResult whose epochs hold the means and, with
    val_gen, val_res_loss and val_seg_iou.

    Data parallel over config.num_devices ranks as train_seg.run_training
    (a caller's `mesh` instead): each rank keeps its slice of the global
    batches and draws; the validation seg IoU that picks the weights is the
    global sample's on every rank; rank 0 alone logs and writes files."""
    mesh, dev, own_mesh = trainer_mesh(config, mesh, device)
    try:
        return _train(config, train_gen, val_gen, steps_per_epoch, val_steps,
                      points_per_shape, pretrained, spline_fit, lamb,
                      val_shapes, val_points, checkpoint, dev, timer, mesh)
    finally:
        if own_mesh:
            mesh.close()


def _train(config, train_gen, val_gen, steps_per_epoch, val_steps,
           points_per_shape, pretrained, spline_fit, lamb, val_shapes,
           val_points, checkpoint, dev, timer, mesh) -> TrainResult:
    from ..data.abc import ABCDataset

    num_accum = max(config.accum, 1)
    with_normals = config.mode == 5
    if train_gen is None:
        ds = ABCDataset(config.batch_size * num_accum,
                        path_prefix=config.dataset or "data/shapes/",
                        train_size=config.num_train or None,
                        val_size=config.num_val or None,
                        test_size=config.num_test or None)
        train_gen = ds.get_train(if_normal_noise=True)
        val_gen = ds.get_val(batch_size=config.batch_size)

    model = PrimitivesEmbedding(emb_size=128, num_primitives=10,
                                mode=5 if with_normals else 0,
                                k=config.knn_k, **network_kwargs(config))
    init_flax_like(model, torch.Generator().manual_seed(config.seed))
    ckpt_dir = os.path.join(config.log_dir, "checkpoints")
    pre_path = os.path.join(ckpt_dir, f"{config.pretrain_model_path}.npz")
    if pretrained is None and config.pretrain_model_path \
            and os.path.exists(pre_path):
        pretrained = load_npz_params(pre_path)
        if mesh.is_main:
            log.info("loaded pretrained segmentation weights from %s",
                     pre_path)
    if pretrained is not None:
        model.load_state_dict(params_from_jax(pretrained, model))
    model.to(dev)
    replicate(mesh, model)
    train_gen = lookahead(train_gen)
    if spline_fit is None:
        spline_fit = trained_spline_fit(config.log_dir, config.grid_size,
                                        dev)
    optimizer = make_optimizer(model.parameters(), config.optim, config.lr,
                               config.weight_decay)
    knobs = dict(FAST_STEP_KNOBS) if config.fast_step else {}
    train_step, eval_step = make_e2e_step(model, spline_fit, optimizer,
                                          lamb=lamb,
                                          with_normals=with_normals,
                                          mesh=mesh, **knobs)
    host_rng = np.random.RandomState(config.seed + 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed + 3)
    steps_per_epoch = steps_per_epoch or max(
        config.num_train // (config.batch_size * num_accum), 1)
    mlog = rank_logger(mesh, config.log_dir, config.model_path)
    ckpt_path = os.path.join(ckpt_dir, f"{config.model_path}.npz")

    def pack(points, labels, normals, prim, rng, n_keep=points_per_shape):
        return pack_batch(points, labels, normals, prim, rng, n_keep,
                          with_normals, dev)

    def draws_of(x, g):
        return draw_e2e(x.shape[0], x.shape[1], MS_NUM_SAMPLES, g, dev)

    val_batches = []
    if val_gen is not None and val_shapes:
        n_val = val_points or points_per_shape
        val_batches = [shard_batch(mesh, vb) for vb in validation_sample(
            val_gen, validation_batches(val_shapes, config.batch_size),
            config.seed, lambda *b: pack(*b, n_keep=n_val),
            lambda x, g: (draws_of(x, g),), dev)]

    def streaming_val():
        # val_shapes None: val_steps fresh batches, subsampled by host_rng
        # and drawn from `gen`, as the training steps are
        for _ in range(val_steps):
            vb = pack(*next(val_gen), host_rng)
            yield shard_batch(mesh, (*vb, draws_of(vb[0], gen)))

    best_val_siou = -float("inf")
    step = 0

    steps, epochs = [], []
    for epoch in range(config.num_epochs):
        t0 = time.time()
        agg = []
        for _ in range(steps_per_epoch):
            x, lab, pr = pack(*next(train_gen), host_rng)
            shape = (num_accum, x.shape[0] // num_accum)
            draws = [draw_e2e(shape[1], x.shape[1], MS_NUM_SAMPLES, gen, dev)
                     for _ in range(num_accum)]
            agg.append(train_step(
                *(shard_batch(mesh, t, axis=1) for t in (
                    x.reshape(*shape, *x.shape[1:]), lab.reshape(*shape, -1),
                    pr.reshape(*shape, -1))),
                [shard_batch(mesh, d) for d in draws], config.lr, timer))
            step += 1
            if checkpoint and mesh.is_main and step % SAVE_EVERY == 0:
                save_npz_params(os.path.join(
                    ckpt_dir, f"{config.model_path}_step{step}.npz"),
                    params_to_jax(model))
        step_floats, tr = mean_metrics(agg)
        steps += step_floats
        if val_gen is not None:
            val = mean_metrics([eval_step(*vb) for vb in (
                val_batches or streaming_val())])[1]
            tr["val_res_loss"] = val["res_loss"]
            tr["val_seg_iou"] = val["seg_iou"]
        if mesh.is_main:
            log.info("epoch %d res %.4f (geom %.4f spline %.4f) embed %.4f "
                     "siou %.3f piou %.3f clusters %.1f%s (%.1fs)", epoch,
                     tr["res_loss"], tr["geom_loss"], tr["spline_loss"],
                     tr["embed_loss"], tr["seg_iou"], tr["prim_iou"],
                     tr["clusters"],
                     (f" | val res {tr['val_res_loss']:.4f} siou "
                      f"{tr['val_seg_iou']:.3f}" if val_gen is not None
                      else ""),
                     time.time() - t0)
        epochs.append(tr)
        mlog.log(epoch, tr)
        improved = not val_batches or tr["val_seg_iou"] > best_val_siou
        if val_batches and improved:
            best_val_siou = tr["val_seg_iou"]
        if checkpoint and improved and mesh.is_main:
            save_npz_params(ckpt_path, params_to_jax(model))
    mlog.close()
    return TrainResult(model, steps, epochs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Fine-tune ParSeNet end to end with the fitting loss.")
    ap.add_argument("config", help="configs/config_parsenet_e2e.yml")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    setup_logging(cfg.log_dir, cfg.model_path)
    snapshot_config(cfg, cfg.log_dir, cfg.model_path)
    run_training(cfg, device=args.device)


if __name__ == "__main__":
    main()
