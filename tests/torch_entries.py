"""One request of each of the port's five entry points, for the span
tests: eval.pipeline.predict_segmentation and batch_metrics (a batch of
shapes), train_seg.make_step_fns(...).train_step, train_e2e.
make_e2e_step(...).train_step and train_spline.make_fed_step(...) (one
optimizer step). `request(entry, dev, n_points, k)` returns a callable
that runs one request from the same start every call: the same shapes,
draws and weights (the trainers' weights copied back and their
optimizer's state dropped), so two calls make the same host
synchronisations. Shapes and spline patches from data.synthetic; the
shipped weights of params/ for the e2e network and the spline decoders."""
from __future__ import annotations

import os

import numpy as np
import torch

from parsenet_tpu_torch.data.synthetic import make_shape_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_WEIGHTS = os.path.join(ROOT, "params", "parsenet_e2e.npz")
# each opens the span entry.<name> around a request or a step
ENTRIES = ("predict_segmentation", "batch_metrics", "seg_train_step",
           "e2e_train_step", "spline_train_step")


def _shapes(batch: int, n_points: int, seed: int = 5):
    return make_shape_batch(np.random.RandomState(seed), batch, n_points)


def _net(dev, k):
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    return load_primitives_embedding(E2E_WEIGHTS, mode=5, k=k, device=dev)


def _generator(dev, seed: int = 3) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def request(entry: str, dev: torch.device, n_points: int, k: int):
    """A callable running one request of `entry` on `dev`: 2 shapes of
    n_points (the trainers: 2 micro-batches), the network's kNN k."""
    if entry == "predict_segmentation":
        from parsenet_tpu_torch.eval import pipeline
        net, (pts, labels, normals, prim) = _net(dev, k), _shapes(2, n_points)
        return lambda: pipeline.predict_segmentation(
            net, pts, normals, labels, prim, generator=_generator(dev),
            device=dev)
    if entry == "batch_metrics":
        from parsenet_tpu_torch.eval import pipeline
        from parsenet_tpu_torch.fitting.spline_apply import build_spline_fit
        net, (pts, labels, normals, prim) = _net(dev, k), _shapes(2, n_points)
        fit = build_spline_fit(device=dev)
        return lambda: pipeline.batch_metrics(
            net, pts, normals, labels, prim, _generator(dev), ms_bf16=True,
            spline_fit=fit, device=dev)
    if entry == "seg_train_step":
        return _seg_step(dev, n_points, k)
    if entry == "e2e_train_step":
        return _e2e_step(dev, n_points, k)
    if entry == "spline_train_step":
        return _spline_step(dev, n_points, k)
    raise ValueError(f"unknown entry {entry!r}")


def _batch(dev, n_points):
    pts, labels, normals, prim = _shapes(2, n_points)
    x = torch.as_tensor(np.concatenate([pts, normals], -1)[:, None],
                        dtype=torch.float32, device=dev)
    return (x, torch.as_tensor(labels[:, None], device=dev).long(),
            torch.as_tensor(prim[:, None], device=dev).long())


def _from_the_start(model, opt, step):
    """`step` run from the model's and the optimizer's state of now: the
    weights and buffers copied back on the device (no host sync) and the
    optimizer's state dropped before each call."""
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run():
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(start[k])
        opt.state.clear()
        return step()
    return run


def _seg_step(dev, n_points, k):
    from parsenet_tpu_torch.losses.embedding import draw_triplet
    from parsenet_tpu_torch.models import dgcnn
    from parsenet_tpu_torch.train import state, train_seg
    x, labels, prim = _batch(dev, n_points)
    model = dgcnn.PrimitivesEmbedding(emb_size=128, num_primitives=10,
                                      mode=5, k=k)
    dgcnn.init_flax_like(model, torch.Generator().manual_seed(0))
    model.to(dev)
    opt = state.make_optimizer(model.parameters(), "adam", 1e-3)
    train_step, _ = train_seg.make_step_fns(model, opt)
    u_pts, u_pairs = draw_triplet(2, _generator(dev), dev)
    return _from_the_start(model, opt, lambda: train_step(
        x, labels, prim, u_pts[:, None], u_pairs[:, None], 1e-3))


def _e2e_step(dev, n_points, k):
    from parsenet_tpu_torch.fitting.spline_apply import build_spline_fit
    from parsenet_tpu_torch.train import state, train_e2e
    x, labels, prim = _batch(dev, n_points)
    model = _net(dev, k).train()
    opt = state.make_optimizer(model.parameters(), "adam", 1e-4)
    subset = min(2048, n_points)
    train_step, _ = train_e2e.make_e2e_step(
        model, build_spline_fit(device=dev), opt, ms_num_samples=subset)
    gen = _generator(dev)
    draws = [train_e2e.draw_e2e(1, n_points, subset, gen, dev)
             for _ in range(2)]
    return _from_the_start(model, opt, lambda: train_step(
        x, labels, prim, draws, 1e-4))


def _spline_step(dev, n_points, k):
    """The closed SplineNet's fed step on 2 patches of n_points, every
    call from a fresh feed of the same batch and a fresh RandomState (the
    trainer's kNN k is its own, 10)."""
    import itertools
    from parsenet_tpu_torch.core.config import Config
    from parsenet_tpu_torch.data.splines import canon_batch
    from parsenet_tpu_torch.data.synthetic import make_spline_batch
    from parsenet_tpu_torch.train import train_spline
    pts, cps = make_spline_batch(np.random.RandomState(5), 2, n_points,
                                 closed=True)
    batch = canon_batch(pts, cps, True, True)
    model, opt, train_step, _ = train_spline.make_trainer(
        Config(grid_size=20, seed=0, lr=1e-3), True, True, dev)

    def step():
        fed = train_spline.make_fed_step(
            train_step, itertools.repeat(batch), np.random.RandomState(0),
            (n_points,), dev)
        return fed(1e-3, 0.9)
    return _from_the_start(model, opt, step)


def host_spans(prof) -> list:
    """(name, start_us, end_us) of the host's record_function ranges of a
    torch.profiler capture."""
    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and getattr(e, "is_user_annotation", False)]


def profiled(run) -> list:
    """host_spans of one call of `run` under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return host_spans(prof)
