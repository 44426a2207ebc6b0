"""The reference's training steps: the segmentation loss (triplet + type
NLL) and the e2e loss (those plus the fitting loss through mean-shift, the
matching, the fits and the frozen SplineNets), their gradients by autograd
over the plain paths, averaged over the micro-batches, zeroed where any
entry is not finite, and Adam written out (b1 0.9, b2 0.999, eps 1e-8
outside the square root, both moments bias-corrected)."""
from __future__ import annotations

import numpy as np
import torch

from .plain.core.checkpoint import load_npz_params
from .plain.fitting.pipeline import fitting_loss_shape
from .plain.losses.embedding import (draw_triplet, primitive_nll_loss,
                                     triplet_loss)
from .plain.models.dgcnn import (PrimitivesEmbedding, init_flax_like,
                                 params_from_jax)
from .plain.fitting.spline_apply import build_spline_fit

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def network(cfg: dict, dev, init_seed=None, weights=None):
    """The configuration's network: flax's initialisation from a CPU
    generator seeded init_seed, or the weights of an npz."""
    net = cfg["network"]
    model = PrimitivesEmbedding(emb_size=net["emb_size"],
                                num_primitives=net["num_primitives"],
                                mode=net["mode"], k=net["k"])
    if weights is None:
        init_flax_like(model, torch.Generator().manual_seed(init_seed))
    else:
        model.load_state_dict(params_from_jax(load_npz_params(weights),
                                              model))
    return model.to(dev)


def inputs(batch, dev):
    """(points, labels, normals, prim) numpy -> x [S, K, 6], labels, prim."""
    pts, labels, normals, prim = batch
    x = np.concatenate([pts, normals], -1).astype(np.float32)
    return (torch.as_tensor(x, device=dev),
            torch.as_tensor(labels, dtype=torch.int64, device=dev),
            torch.as_tensor(prim, dtype=torch.int64, device=dev))


def adam_run(model, steps: list, lr: float) -> dict:
    """steps: for each step, its micro-batches' loss closures. -> the
    step losses (mean over micro-batches), the first step's gradient norm
    a leaf and each leaf's change over all the steps."""
    named = list(model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in named}
    m = {k: torch.zeros_like(p) for k, p in named}
    v = {k: torch.zeros_like(p) for k, p in named}
    losses, grad = [], {}
    for t, micro in enumerate(steps, 1):
        for _, p in named:
            p.grad = None
        total = 0.0
        for loss_fn in micro:
            loss = loss_fn()
            loss.backward()
            total += float(loss.detach())
        losses.append(total / len(micro))
        g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             / len(micro) for k, p in named}
        finite = all(bool(torch.isfinite(x).all()) for x in g.values())
        if not finite:
            g = {k: torch.zeros_like(x) for k, x in g.items()}
        if t == 1:
            grad = {k: float(torch.linalg.norm(x.double()))
                    for k, x in g.items()}
        with torch.no_grad():
            for k, p in named:
                m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g[k]
                v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * g[k] * g[k]
                m_hat = m[k] / (1 - BETAS[0] ** t)
                v_hat = v[k] / (1 - BETAS[1] ** t)
                p -= lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    change = {k: float(torch.linalg.norm((p.detach() - p0[k]).double()))
              for k, p in named}
    return {"losses": losses, "grad": grad, "change": change}


def seg_steps(cfg: dict, batches: list, gen, accum: int, batch: int,
              init_seed: int, lr: float, dev, half: bool = False) -> dict:
    """The segmentation steps on `batches` (each [accum * batch] shapes),
    the triplet draws of each step drawn from `gen` as the trainer does.
    half: the planted fault of the check's readings, each micro-batch's
    loss taken over the first half of its shapes."""
    model = network(cfg, dev, init_seed=init_seed)
    steps = []
    for b in batches:
        x, labels, prim = inputs(b, dev)
        u_pts, u_pairs = draw_triplet(accum * batch, gen, dev)
        micro = []
        for a in range(accum):
            s = slice(a * batch, a * batch + (batch // 2 if half else batch))

            def loss_fn(s=s, x=x, labels=labels, prim=prim, u_pts=u_pts,
                        u_pairs=u_pairs):
                emb, logp = model(x[s])
                return (triplet_loss(emb, labels[s], u_pts[s], u_pairs[s])
                        + primitive_nll_loss(logp, prim[s]))
            micro.append(loss_fn)
        steps.append(micro)
    return adam_run(model, steps, lr)


def e2e_draws(batch: int, n: int, subset: int, gen, dev):
    """A micro-batch's draws as the trainer makes them: the triplet
    uniforms, then each shape's bandwidth subset."""
    u_pts, u_pairs = draw_triplet(batch, gen, dev)
    s = min(subset, n)
    sub = (torch.stack([torch.randperm(n, generator=gen, device=dev)[:s]
                        for _ in range(batch)]) if s < n else None)
    return u_pts, u_pairs, sub


def e2e_steps(cfg: dict, batches: list, gen, accum: int, batch: int,
              weights: str, params_dir: str, lr: float, dev,
              half: bool = False) -> dict:
    """The e2e steps on `batches`: the network from `weights`, the frozen
    decoders of params_dir. half: the planted fault of the check's
    readings, the step's gradient and loss the mean over its first
    (accum + 1) // 2 micro-batches (one shape each)."""
    tr, sl = cfg["e2e_training"], cfg["spline_slots"]
    model = network(cfg, dev, weights=weights)
    fit = build_spline_fit(grid=sl["grid"], sample_grid=sl["sample_grid"],
                           params_dir=params_dir, device=dev)
    steps = []
    for b in batches:
        x, labels, prim = inputs(b, dev)
        n = x.shape[1]
        draws = [e2e_draws(batch, n, tr["subset"], gen, dev)
                 for _ in range(accum)]
        micro = []
        for a in range(accum):
            s = slice(a * batch, (a + 1) * batch)

            def loss_fn(s=s, d=draws[a], x=x, labels=labels, prim=prim):
                return e2e_loss(model, fit, x[s], labels[s], prim[s], d, tr)
            micro.append(loss_fn)
        steps.append(micro[:(accum + 1) // 2] if half else micro)
    return adam_run(model, steps, lr)


def e2e_loss(model, fit, x, labels, prim, draws, tr: dict):
    """The e2e trainer's loss of one micro-batch: triplet + NLL + the mean
    over its shapes of the fitting loss."""
    u_pts, u_pairs, subset = draws
    emb, logp = model(x)
    e_loss = triplet_loss(emb, labels, u_pts, u_pairs)
    p_loss = primitive_nll_loss(logp, prim)
    pred_prim = torch.argmax(logp, dim=-1)
    points, normals = x[..., :3], x[..., 3:6]
    res = [fitting_loss_shape(
        points[b], normals[b], emb[b], labels[b], prim[b],
        subset=None if subset is None else subset[b],
        pred_prim_per_point=pred_prim[b], spline_fit=fit,
        quantile=tr["quantile"], iterations=tr["iterations"],
        lamb=tr["lamb"], ms_num_samples=tr["subset"],
        spline_stride=tr["spline_stride"]).loss
        for b in range(x.shape[0])]
    return e_loss + p_loss + torch.mean(torch.stack(res))

