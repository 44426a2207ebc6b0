"""Port parity: what the e2e and segmentation trainers are built from,
against the JAX package: the weight-decay optimizer and the zero-and-step
gradient guard (against optax), the DGCNN weights carried to the flax
layout and back, the training-state checkpoint, the ABC h5 dataset, the
coverage draw's fixed-order cdf, and both trainers' run_training end to
end on a tiny h5 (the segmentation checkpoint resumed, then fine-tuned
from by the e2e trainer)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.data import abc as jabc
from parsenet_tpu.data.synthetic import write_abc_h5
from parsenet_tpu.train import state as jstate
from parsenet_tpu_torch.core import checkpoint as tckpt
from parsenet_tpu_torch.core.config import Config
from parsenet_tpu_torch.data import abc as tabc
from parsenet_tpu_torch.eval.pipeline import fixed_order_cdf
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             init_flax_like, params_from_jax,
                                             params_to_jax)
from parsenet_tpu_torch.train import state as tstate
from parsenet_tpu_torch.train import train_e2e as te2e
from parsenet_tpu_torch.train import train_seg as tseg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _apply_jax(tx, jp, opt_state, grads, lr, guard):
    """One step of the JAX trainers: grads zeroed where any entry is not
    finite (train_seg.py / train_e2e.py), the update, x lr."""
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    if guard:
        ok = jstate.grad_finite(g)
        g = jax.tree_util.tree_map(lambda a: jnp.where(ok, a, 0.0), g)
    upd, opt_state = tx.update(g, opt_state, jp)
    return {k: jp[k] + lr * upd[k] for k in jp}, opt_state


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_weight_decay_optimizer_matches_optax(rng, name):
    """make_optimizer(..., weight_decay) against optax's chain (the
    update, add_decayed_weights, x lr, x -1) over 3 steps with a changing
    lr: 1e-6."""
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jstate.make_optimizer(name, weight_decay=0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = tstate.make_optimizer(tp.values(), name, weight_decay=0.05)
    for lr in (1e-2, 5e-3, 2e-2):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        jp, opt_state = _apply_jax(tx, jp, opt_state, g, lr, False)
        tstate.set_lr(opt, lr)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_gradient_guard_zeroes_and_still_steps(rng):
    """A step with finite gradients, then one with a NaN and an inf: the
    guard zeroes every gradient, Adam still steps, and its momentum moves
    the weights, as the JAX trainers do (1e-6)."""
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jstate.make_optimizer("adam")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = tstate.make_optimizer(tp.values(), "adam", lr=1e-2)
    before = None
    for bad in (False, True):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        if bad:
            g["a"][1, 2], g["b"][0] = np.nan, np.inf
        jp, opt_state = _apply_jax(tx, jp, opt_state, g, 1e-2, True)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        ok = tstate.guard_gradients(tp.values())
        assert bool(ok) == (not bad)
        if bad:
            assert all(float(t.grad.abs().sum()) == 0.0 for t in tp.values())
            before = {k: t.detach().clone() for k, t in tp.items()}
        opt.step()
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        assert not torch.equal(tp[k].detach(), before[k])   # it moved


def test_params_to_jax_round_trips_the_shipped_weights():
    """params/parsenet_e2e.npz -> the model -> the flax layout: every key,
    bit for bit."""
    flat = tckpt.load_npz_params(os.path.join(REPO, "params",
                                              "parsenet_e2e.npz"))
    model = PrimitivesEmbedding(mode=5, k=80)
    model.load_state_dict(params_from_jax(flat, model))
    back = params_to_jax(model)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_init_flax_like_sets_every_parameter():
    model = PrimitivesEmbedding(emb_size=16, mode=5, k=4)
    for p in model.parameters():
        p.data.fill_(7.0)
    init_flax_like(model, torch.Generator().manual_seed(0))
    w = model.encoder.mlp1.weight
    assert float(w.abs().max()) <= 2.0 * (1.0 / 256) ** 0.5 / 0.8796
    assert float(model.encoder.mlp1.bias.abs().max()) == 0.0
    assert all(float(p.data.max()) < 7.0 for p in model.parameters())


def test_train_state_checkpoint_round_trip(tmp_path):
    model = PrimitivesEmbedding(emb_size=16, mode=5, k=4)
    opt = tstate.make_optimizer(model.parameters(), "adam")
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    path = str(tmp_path / "ck" / "seg.npz")
    assert tckpt.load_train_state(path) is None
    tckpt.save_train_state(path, params_to_jax(model), opt.state_dict(), 7)
    flat, opt_state, step = tckpt.load_train_state(path)
    assert step == 7
    model2 = PrimitivesEmbedding(emb_size=16, mode=5, k=4)
    model2.load_state_dict(params_from_jax(flat, model2))
    opt2 = tstate.make_optimizer(model2.parameters(), "adam")
    opt2.load_state_dict(opt_state)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
        assert torch.equal(opt.state[a]["exp_avg"], opt2.state[b]["exp_avg"])


def test_abc_dataset_batches_match_jax(tmp_path):
    """Train (augmented, noisy normals, aligned) and val batches, draw for
    draw the JAX package's ABCDataset's."""
    prefix = str(tmp_path) + "/"
    for split, n in (("train", 6), ("val", 4), ("test", 2)):
        write_abc_h5(f"{prefix}{split}_data.h5", n, num_points=200,
                     seed=len(split))
    kw = dict(path_prefix=prefix, train_size=6, val_size=4, test_size=2)
    jd, td = jabc.ABCDataset(2, **kw), tabc.ABCDataset(2, **kw)
    for jg, tg in ((jd.get_train(), td.get_train()),
                   (jd.get_val(batch_size=2), td.get_val(batch_size=2))):
        for _ in range(4):
            for a, b in zip(next(jg), next(tg)):
                np.testing.assert_array_equal(a, b)


def test_abc_dataset_raises_without_its_h5(tmp_path):
    with pytest.raises((FileNotFoundError, OSError)):
        tabc.ABCDataset(2, path_prefix=str(tmp_path) + "/")


def test_fixed_order_cdf_matches_a_float64_scan():
    """The coverage draw's cdf over a stream-a-sized weight vector (50
    segments x 4,096 samples, some segments trimmed to zero) against a
    float64 sequential cumsum: 1e-6 relative at every entry."""
    r = np.random.RandomState(0)
    w = (r.rand(50, 4096) * (r.rand(50, 1) > 0.3)
         * (r.rand(50, 4096) > 0.05)).astype(np.float32).reshape(-1)
    got = fixed_order_cdf(torch.from_numpy(w)).numpy().astype(np.float64)
    want = np.cumsum(w.astype(np.float64))
    nz = want > 0
    assert got.shape == want.shape
    assert np.all(np.abs(got - want)[nz] <= 1e-6 * want[nz])
    assert np.all(got[~nz] == 0.0)
    # a length that is not a multiple of the rows
    got = fixed_order_cdf(torch.from_numpy(w[:1001])).numpy()
    np.testing.assert_allclose(got, np.cumsum(w[:1001].astype(np.float64)),
                               rtol=1e-6)


def _tiny_config(tmp_path, **kw):
    prefix = str(tmp_path) + "/"
    for split, n in (("train", 4), ("val", 2), ("test", 1)):
        if not os.path.exists(f"{prefix}{split}_data.h5"):
            write_abc_h5(f"{prefix}{split}_data.h5", n, num_points=300,
                         seed=len(split))
    base = dict(dataset=prefix, num_train=4, num_val=2, num_test=1,
                batch_size=1, mode=5, knn_k=4, num_epochs=1,
                log_dir=str(tmp_path / "logs"), seed=0)
    return Config(**{**base, **kw})


def test_trainers_run_from_the_h5(tmp_path):
    """train_seg from the h5 (accum 2, 256 points) saves its weights and
    optimizer state, and a preload_model run resumes from them; train_e2e
    then fine-tunes from that checkpoint (pretrain_model_path) with the
    shipped decoders, 1 step of 256 points: losses finite, grad_ok 1."""
    cfg = _tiny_config(tmp_path, model_path="seg", accum=2, lr=1e-3)
    res = tseg.run_training(cfg, steps_per_epoch=1, points_per_shape=256,
                            val_shapes=2, device="cpu")
    assert res.steps[0]["grad_ok"] == 1.0
    assert all(np.isfinite(v) for v in res.epochs[0].values())
    ck = tmp_path / "logs" / "checkpoints" / "seg.npz"
    flat, _, step = tckpt.load_train_state(str(ck))
    assert step == 1
    res2 = tseg.run_training(cfg.replace(preload_model=True),
                             steps_per_epoch=1, points_per_shape=256,
                             val_shapes=2, checkpoint=False, device="cpu")
    assert np.isfinite(res2.steps[0]["embed_loss"])

    cfg_e = _tiny_config(tmp_path, model_path="e2e", accum=1, lr=1e-4,
                         pretrain_model_path="seg")
    res = te2e.run_training(cfg_e, steps_per_epoch=1, points_per_shape=256,
                            val_shapes=1, device="cpu")
    got = params_to_jax(res.model)
    assert any(not np.array_equal(got[k], flat[k]) for k in flat)
    m = res.steps[0]
    assert m["grad_ok"] == 1.0
    assert all(np.isfinite(v) for v in m.values())
    assert os.path.exists(tmp_path / "logs" / "checkpoints" / "e2e.npz")
