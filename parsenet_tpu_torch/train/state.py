"""Optimizer, gradient guard and the loop pieces of the trainers.

Counterpart of parsenet_tpu/train/state.py, with what the segmentation
and e2e trainers share: the accumulated step, the batch subsample, the
fixed validation sample and the epoch's means. There the optimizer is optax's
chain scale_by_adam (b1 0.9, b2 0.999, eps 1e-8 added outside the square
root, both moments bias-corrected) [-> add_decayed_weights(wd)] -> x lr,
injected per step -> x -1. `torch.optim.Adam` with the same betas and eps,
its lr set before every step, is the same update; with weight decay,
`torch.optim.AdamW` is: it scales the weights by (1 - lr wd) and then takes
the Adam step, p - lr (adam + wd p) as optax has it (decay added after
Adam's scaling, then times lr). The tests hold both against optax.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from ..core.logging import MetricsLogger
from ..core.profiling import StageTimer

NO_TIMER = StageTimer(False)


class TrainResult(NamedTuple):
    """What the segmentation and e2e trainers' `run_training` return: the
    trained model, each step's metrics and each epoch's."""
    model: torch.nn.Module
    steps: list
    epochs: list


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adam",
                   lr: float = 1e-3,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam (AdamW with weight_decay) or plain SGD, whose lr the trainer
    sets per step with `set_lr`."""
    if name == "adam" and weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"make_optimizer: unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def grad_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """True iff every gradient entry is finite (reference: src/utils.py:
    393-399, the grad-norm NaN/Inf guard)."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def accumulated_step(optimizer: torch.optim.Optimizer,
                     params: list[torch.nn.Parameter], micro, n_micro: int,
                     keys, lr: float, timer, mesh=None) -> dict:
    """One step of the segmentation and e2e trainers: micro(a) -> (loss,
    metrics) of micro-batch a; the gradients of the n_micro losses summed
    and averaged (the JAX trainers' lax.scan), zeroed where any entry is
    not finite (`guard_gradients`), then the optimizer steps at lr. Returns
    the mean of each metric in `keys` and grad_ok.

    With a parallel.mesh.Mesh each micro-batch is this rank's slice of the
    global one: the averaged gradients are then averaged over the ranks
    (one all-reduce) before the guard, so a non-finite entry on any rank
    zeroes the step on every rank, and the metrics are averaged over the
    ranks too: the one-rank step of the global batch, where each loss and
    metric is a mean over equal shares of it (the triplet loss's
    normaliser is made global in losses.embedding.triplet_loss)."""
    set_lr(optimizer, lr)
    optimizer.zero_grad(set_to_none=True)
    acc = None
    for a in range(n_micro):
        loss, m = micro(a)
        with timer("backward"):
            loss.backward()
        m = {k: m[k].detach() for k in keys}
        acc = m if acc is None else {k: acc[k] + m[k] for k in keys}
    inv = 1.0 / n_micro
    with timer("optimizer"):
        for p in params:
            if p.grad is not None:
                p.grad.mul_(inv)
        if mesh is not None:
            mesh.all_reduce_grads(params)
        ok = guard_gradients(params)
        optimizer.step()
    out = {k: v * inv for k, v in acc.items()}
    out = rank_mean(out, mesh)
    out["grad_ok"] = ok.to(torch.float32)
    return out


def rank_mean(metrics: dict, mesh) -> dict:
    """Each 0-d metric averaged over the ranks of `mesh` (one all-reduce;
    unchanged without a mesh)."""
    if mesh is None:
        return metrics
    keys = list(metrics)
    vals = mesh.all_mean(torch.stack([metrics[k].to(torch.float32)
                                      for k in keys]))
    return {k: vals[i] for i, k in enumerate(keys)}


def guard_gradients(params: Iterable[torch.nn.Parameter]) -> torch.Tensor:
    """The JAX trainers' gradient guard: where any gradient entry is not
    finite, every gradient becomes zero; the optimizer still steps, so Adam's
    momentum moves the weights, as in the JAX package. A parameter without
    a gradient gets zeros, as a JAX gradient tree has them. Returns the
    guard's verdict, True when all were finite (a 0-d bool tensor, no host
    sync)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    ok = grad_finite(p.grad for p in params)
    for p in params:
        p.grad.mul_(ok).nan_to_num_(0.0, 0.0, 0.0)
    return ok


def network_kwargs(config) -> dict:
    """PrimitivesEmbedding's compute settings for a trainer's config:
    half_precision is the JAX trainers' bf16 network with bf16 neighbour
    gathers (parameters and GroupNorm statistics stay f32)."""
    if config.half_precision:
        return {"dtype": torch.bfloat16, "gather_bf16": True}
    return {}


def to_tensor(a: np.ndarray, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def subsample_batch(rng: np.random.RandomState, arrays, n_keep: int):
    """One random point subsample for the whole batch (reference:
    train_parsenet.py:160-169)."""
    sel = rng.choice(arrays[0].shape[1], n_keep, replace=False)
    return [None if a is None else a[:, sel] for a in arrays]


def pack_batch(points, labels, normals, prim, rng: np.random.RandomState,
               n_keep: int, with_normals: bool, dev):
    """A numpy batch (points [B, N, 3], labels, normals, prim) subsampled
    to n_keep points (`subsample_batch`), the normals appended to the
    points where the network reads them -> (x, labels, prim) tensors."""
    points, labels, normals, prim = subsample_batch(
        rng, [points, labels, normals, prim], min(n_keep, points.shape[1]))
    x = np.concatenate([points, normals], -1) if with_normals else points
    return (to_tensor(x, dev), to_tensor(labels, dev, torch.int64),
            to_tensor(prim, dev, torch.int64))


def validation_sample(val_gen: Iterator, n_batches: int, seed: int,
                      pack: Callable, draw: Callable, dev) -> list:
    """The FIXED validation sample: n_batches batches of val_gen, each
    packed by pack(*batch, rng) with one RandomState(seed + 17), plus its
    draws draw(x, generator) from a generator seeded seed + 1000 + i: the
    same shapes, points and draws every epoch. Returns [(x, labels, prim,
    *draws)]."""
    rng = np.random.RandomState(seed + 17)
    out = []
    for i in range(n_batches):
        x, labels, prim = pack(*next(val_gen), rng)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1000 + i)
        out.append((x, labels, prim, *draw(x, gen)))
    return out


def validation_batches(n_shapes, batch_size: int) -> int:
    """The batches of a fixed validation sample of n_shapes shapes:
    ceil(n_shapes / batch_size), at least one."""
    return max(1, -(-n_shapes // batch_size))


def mean_metrics(metrics: list) -> tuple:
    """([{key: float}], {key: mean}) of a list of metric dicts of 0-d
    tensors: one host sync a value, where the epoch ends."""
    floats = [{k: float(v) for k, v in m.items()} for m in metrics]
    return floats, {k: float(np.mean([m[k] for m in floats]))
                    for k in floats[0]}


class _NoLog:
    def log(self, step, metrics) -> None:
        pass

    def close(self) -> None:
        pass


def rank_logger(mesh, log_dir: str, name: str):
    """The MetricsLogger on rank 0 (or without a mesh); a logger that
    writes nothing on the other ranks."""
    if mesh is None or mesh.is_main:
        return MetricsLogger(log_dir, name)
    return _NoLog()


def trainer_mesh(config, mesh, device):
    """(mesh, device, owned) of a trainer's run: the caller's mesh, else
    parallel.mesh.make_mesh(config.num_devices) on `device` (None =
    "cuda"), which the trainer closes when it ends (owned). The device is
    the rank's."""
    if mesh is not None:
        return mesh, mesh.device, False
    from ..parallel.mesh import make_mesh
    mesh = make_mesh(config.num_devices, device=device)
    return mesh, mesh.device, mesh.owns
