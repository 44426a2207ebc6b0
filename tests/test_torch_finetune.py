"""Port parity: the trainers' validation, as the fine-tune route runs it.

The e2e trainer (train/train_e2e.run_training) draws its FIXED validation
sample at `val_points` (parsenet_tpu/train/train_e2e.py:310-320), which
cli.finetune_e2e sets to the 10,000 points the shipping gate measures
while it trains at 8,000; with val_shapes=None it scores `val_steps`
streaming batches an epoch (:365-378). The segmentation trainer takes
`val_steps` batches as its fixed sample where val_shapes is None
(parsenet_tpu/train/train_seg.py:171-172).

* The selection: both packages' run_training with their step functions
  replaced by recorders (nothing compiled but the network's init); the
  validation batches each eval_step receives are equal bit for bit, at
  val_points 1,024 while training takes 512, and, streaming, val_steps of
  them an epoch, each epoch logging val_res_loss and val_seg_iou.
* The metrics: the port's run_training at lr 0 from the JAX package's
  weights, its validation draws the JAX package's keys' (handed over as
  tests/test_torch_train_e2e.py hands them), against the JAX package's
  eval_step on the batch it selected: val_seg_iou and val_res_loss within
  2e-3 relative (the e2e parity limit); val_embed_loss of the
  segmentation trainer with val_shapes=None within 1e-3 relative of the
  JAX trainer's own run.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import flatten_tree
from parsenet_tpu.core.config import Config as JaxConfig
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu.models.splinenet import SplineNet as JaxSplineNet
from parsenet_tpu.train import train_e2e as je2e
from parsenet_tpu.train import train_seg as jseg
from parsenet_tpu.train.state import create_state
from parsenet_tpu_torch.core.config import Config
from parsenet_tpu_torch.models.dgcnn import params_from_jax
from parsenet_tpu_torch.train import train_e2e as te2e
from parsenet_tpu_torch.train import train_seg as tseg
from test_torch_train_e2e import jax_triplet_draws, port_decoders

torch.set_num_threads(1)

N_SHAPE, TRAIN_PTS, VAL_PTS, K = 1536, 512, 1024, 8
E2E_RTOL, SEG_RTOL = 2e-3, 1e-3
METRIC_KEYS = ("embed_loss", "prim_loss", "res_loss", "geom_loss",
               "spline_loss", "seg_iou", "prim_iou", "clusters")


def _batches(seed, n_batches, batch):
    p, l_, n, pr = make_shape_batch(np.random.RandomState(seed),
                                    n_batches * batch, N_SHAPE)
    return [tuple(a[i * batch:(i + 1) * batch] for a in (p, l_, n, pr))
            for i in range(n_batches)]


def _kw(tmp_path, tag, **kw):
    base = dict(model_path="ft", mode=5, knn_k=K, batch_size=1, accum=1,
                num_epochs=1, lr=0.0, num_devices=1, seed=4,
                log_dir=str(tmp_path / tag))
    base.update(kw)
    return base


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _zeros(keys, make):
    return {k: make(0.0) for k in keys}


def _jax_e2e_recorded(monkeypatch, tmp_path, tag, val_shapes, val_steps,
                      epochs=1):
    """The JAX trainer's loop with recording step functions: the eval
    inputs of every call (numpy) and its metrics log."""
    seen = []

    def make_step(*a, **k):
        def train_step(state, x, lab, pr, key, lr):
            return state, _zeros(METRIC_KEYS, jnp.float32)

        def eval_step(state, x, lab, pr, key):
            seen.append((np.asarray(x), np.asarray(lab), np.asarray(pr),
                         key))
            return _zeros(METRIC_KEYS, jnp.float32)
        return train_step, eval_step

    monkeypatch.setattr(je2e, "make_e2e_step", make_step)
    monkeypatch.setattr(je2e, "build_spline_fit", lambda *a, **k: None)
    cfg = JaxConfig(**_kw(tmp_path, tag, num_epochs=epochs))
    je2e.run_training(cfg, iter(_batches(1, 4, 1)), iter(_batches(2, 8, 1)),
                      steps_per_epoch=1, val_steps=val_steps,
                      points_per_shape=TRAIN_PTS, val_shapes=val_shapes,
                      val_points=VAL_PTS)
    with open(os.path.join(cfg.log_dir, "tensorboard", "ft",
                           "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    return seen, logged


def _port_e2e_recorded(monkeypatch, tmp_path, tag, val_shapes, val_steps,
                       epochs=1):
    seen = []

    def make_step(*a, **k):
        def train_step(x, lab, pr, draws, lr, timer):
            return {**_zeros(te2e.METRICS, torch.tensor),
                    "grad_ok": torch.tensor(1.0)}

        def eval_step(x, lab, pr, draws):
            seen.append((x.numpy(), lab.numpy(), pr.numpy(), draws))
            return _zeros(te2e.METRICS, torch.tensor)
        return train_step, eval_step

    monkeypatch.setattr(te2e, "make_e2e_step", make_step)
    res = te2e.run_training(
        Config(**_kw(tmp_path, tag, num_epochs=epochs)),
        iter(_batches(1, 4, 1)), iter(_batches(2, 8, 1)), steps_per_epoch=1,
        val_steps=val_steps, points_per_shape=TRAIN_PTS,
        val_shapes=val_shapes, val_points=VAL_PTS, spline_fit=object(),
        device="cpu")
    return seen, res


def _same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for a, b in zip(g[:3], r[:3]):
            np.testing.assert_array_equal(a, b)


def test_e2e_fixed_sample_is_drawn_at_val_points(monkeypatch, tmp_path):
    ref, logged = _jax_e2e_recorded(monkeypatch, tmp_path, "jax", 2, 2)
    got, res = _port_e2e_recorded(monkeypatch, tmp_path, "port", 2, 2)
    assert [r[0].shape for r in ref] == [(1, VAL_PTS, 6)] * 2
    _same_batches(got, ref)
    assert "val_seg_iou" in logged[0] and "val_seg_iou" in res.epochs[0]


def test_e2e_streams_val_steps_batches_without_a_sample(monkeypatch,
                                                        tmp_path):
    """val_shapes=None: 3 batches an epoch for 2 epochs, subsampled by the
    training stream's RandomState at points_per_shape, val metrics logged
    every epoch, and the weights saved every epoch."""
    ref, logged = _jax_e2e_recorded(monkeypatch, tmp_path, "jax", None, 3,
                                    epochs=2)
    got, res = _port_e2e_recorded(monkeypatch, tmp_path, "port", None, 3,
                                  epochs=2)
    assert len(ref) == 6 and ref[0][0].shape == (1, TRAIN_PTS, 6)
    _same_batches(got, ref)
    for rec in (*logged, *res.epochs):
        assert {"val_res_loss", "val_seg_iou"} <= set(rec)
    assert os.path.exists(tmp_path / "port" / "checkpoints" / "ft.npz")


@pytest.fixture(scope="module")
def jax_e2e_eval():
    """The JAX package's eval_step (make_e2e_step as run_training makes it,
    decoders at grid 10 / sample grid 8) and its weights."""
    jmodel = JaxEmbedding(emb_size=128, num_primitives=10, mode=5, k=K)
    rng = jax.random.PRNGKey(0)
    state = create_state(jmodel, rng, (jnp.zeros((1, 256, 6)),))
    open_vars, closed_vars = (JaxSplineNet(grid=10, k=10, mode=m).init(
        rng, jnp.zeros((1, 128, 3)), train=False) for m in (0, 1))
    jfit = je2e.build_spline_fit(grid=10, sample_grid=8, open_vars=open_vars,
                                 closed_vars=closed_vars)
    eval_step = je2e.make_e2e_step(jmodel, jfit, lamb=0.1,
                                   with_normals=True)[1]
    return state, eval_step, port_decoders(open_vars, closed_vars, 8)


def test_e2e_val_metrics_at_val_points_match_jax(monkeypatch, tmp_path,
                                                 jax_e2e_eval):
    state, eval_step, decoders = jax_e2e_eval
    ref_in, _ = _jax_e2e_recorded(monkeypatch, tmp_path, "jax", 1, 2)
    monkeypatch.undo()
    (vx, vl, vpr, vkey), = ref_in
    ref = {k: float(v) for k, v in eval_step(state, jnp.asarray(vx),
                                             jnp.asarray(vl),
                                             jnp.asarray(vpr),
                                             vkey).items()}
    # the port's first draw_e2e call is its validation sample's: hand it
    # the JAX package's draws of that key (no mean-shift subset: 1,024
    # points are fewer than the 2,048 the step samples)
    u_pts, u_pairs = jax_triplet_draws(jax.random.split(vkey)[0], 1)
    calls, draw = [], te2e.draw_e2e

    def jax_draws(*a, **k):
        calls.append(a)
        if len(calls) == 1:
            return te2e.E2EDraws(u_pts, u_pairs, None)
        return draw(*a, **k)

    monkeypatch.setattr(te2e, "draw_e2e", jax_draws)
    res = te2e.run_training(
        Config(**_kw(tmp_path, "port")), iter(_batches(1, 4, 1)),
        iter(_batches(2, 8, 1)), steps_per_epoch=1,
        points_per_shape=TRAIN_PTS, val_shapes=1, val_points=VAL_PTS,
        pretrained=_flat({"params": state.params}), spline_fit=decoders,
        checkpoint=False, device="cpu")
    assert calls[0][:2] == (1, VAL_PTS)
    got = res.epochs[0]
    print({k: (got[f"val_{k}"], ref[k]) for k in ("seg_iou", "res_loss")})
    for k in ("seg_iou", "res_loss"):
        assert abs(got[f"val_{k}"] - ref[k]) <= E2E_RTOL * abs(ref[k]), k


def test_seg_trainer_takes_val_steps_batches_without_val_shapes(
        monkeypatch, tmp_path):
    """val_shapes=None, val_steps=2: both packages train one step at lr 0
    from the same weights and score the same 2 fixed batches with the same
    draws."""
    train, val = _batches(5, 2, 4), _batches(6, 2, 2)
    kw = dict(steps_per_epoch=1, val_steps=2, points_per_shape=256,
              val_shapes=None)
    jcfg = JaxConfig(**_kw(tmp_path, "jax", batch_size=2, accum=2))
    jstate = jseg.run_training(jcfg, iter(train), iter(val), **kw)
    with open(os.path.join(jcfg.log_dir, "tensorboard", "ft",
                           "metrics.jsonl")) as f:
        ref = json.loads(f.readline())["val_embed_loss"]

    flat = _flat({"params": jstate.params})
    monkeypatch.setattr(tseg, "init_flax_like", lambda m, g: m.load_state_dict(
        params_from_jax(flat, m)))
    calls, draw = [], tseg.draw_triplet

    def jax_draws(batch, generator, device):
        calls.append(batch)
        if len(calls) <= 2:      # the validation sample's, in order
            return jax_triplet_draws(
                jax.random.PRNGKey(jcfg.seed + 1000 + len(calls) - 1), batch)
        return draw(batch, generator, device)

    monkeypatch.setattr(tseg, "draw_triplet", jax_draws)
    res = tseg.run_training(Config(**_kw(tmp_path, "port", batch_size=2,
                                         accum=2)),
                            iter(train), iter(val), checkpoint=False,
                            device="cpu", **kw)
    got = res.epochs[0]["val_embed_loss"]
    print("val_embed_loss", got, ref)
    assert calls[:2] == [2, 2]
    assert abs(got - ref) <= SEG_RTOL * abs(ref)
