"""Port parity: the SplineNet trainer (train/train_spline.py) and what it
is built from (train/state.py, core/checkpoint.py, core/config.py,
data/splines.py) against the JAX package, at a small size: grid 8, k 4,
4 patches of 128 points."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core import checkpoint as jckpt
from parsenet_tpu.core.config import load_config as jax_load_config
from parsenet_tpu.data.synthetic import make_spline_batch
from parsenet_tpu.models.splinenet import SplineNet as JaxSplineNet
from parsenet_tpu.ops.bspline import uniform_knot_bspline
from parsenet_tpu.train import state as jstate
from parsenet_tpu.train import train_spline as jts
from parsenet_tpu_torch.core import checkpoint as tckpt
from parsenet_tpu_torch.core.config import Config, load_config
from parsenet_tpu_torch.data import splines as tspl
from parsenet_tpu_torch.models import splinenet as tsn
from parsenet_tpu_torch.train import state as tstate
from parsenet_tpu_torch.train import train_spline as tts

torch.set_num_threads(1)

GRID, K, B, N = 8, 4, 4, 128


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def test_adam_matches_optax(rng):
    """torch.optim.Adam with its lr set per step against the JAX package's
    optax chain (scale_by_adam, x lr, x -1) on a toy tree, after 1 and 3
    steps with a changing lr: 1e-6."""
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]
    tx = jstate.make_optimizer("adam")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = tstate.make_optimizer(tp.values(), "adam")
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = {k: jp[k] + lr * upd[k] for k in jp}
        tstate.set_lr(opt, lr)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        if i in (0, 2):
            for k in jp:
                np.testing.assert_allclose(tp[k].detach().numpy(),
                                           np.asarray(jp[k]), rtol=1e-6,
                                           atol=1e-6)


def test_grad_finite():
    assert bool(tstate.grad_finite([torch.ones(3), torch.zeros(2)]))
    assert not bool(tstate.grad_finite([torch.ones(3),
                                        torch.tensor([1.0, float("nan")])]))


def _batch(closed: bool, seed: int = 0):
    pts, cps = make_spline_batch(np.random.RandomState(seed), B, N, GRID,
                                 closed)
    return tspl.canon_batch(pts, cps, True, True)[:3]


@pytest.mark.parametrize("closed", [False, True])
def test_train_step_matches_jax(closed):
    """One train_step of each from the same flax init on the same batch:
    metrics 1e-4 relative, batch_stats 1e-5, and the parameters after the
    step 1e-4. The step is plain SGD at lr 1, so the parameters move by
    exactly the gradient: Adam's first step, lr g / (|g| + 1e-8), would turn
    the round-off gradients of bn5's bias and of conv6's and conv7's biases
    (about 1e-8: the next BatchNorm cancels them) into steps of up to a
    full lr of either sign. Adam itself is held to optax above."""
    pts, cps, scales = _batch(closed)
    nu, nv = uniform_knot_bspline(GRID, GRID, 3, 3, 40)
    jm = JaxSplineNet(grid=GRID, k=K, mode=int(closed))
    state = jstate.create_state(jm, jax.random.PRNGKey(0),
                                (jnp.zeros((B, N, 3)),), optimizer="sgd",
                                train=True)
    init = _flat({"params": state.params, "batch_stats": state.batch_stats})
    j_step, _ = jts.make_train_step(jm, jnp.asarray(nu), jnp.asarray(nv),
                                    GRID, closed, True)
    new_state, ref = j_step(state, jnp.asarray(pts), jnp.asarray(cps),
                            jnp.asarray(scales), jnp.float32(1.0),
                            jnp.float32(0.9))
    want = _flat({"params": new_state.params,
                  "batch_stats": new_state.batch_stats})

    tm = tsn.SplineNet(grid=GRID, k=K, mode=int(closed))
    tm.load_state_dict(tsn.params_from_jax(init, tm))
    t_step, _ = tts.make_train_step(
        tm, tstate.make_optimizer(tm.parameters(), "sgd"),
        torch.from_numpy(nu), torch.from_numpy(nv), GRID, closed, True)
    got = t_step(*map(torch.from_numpy, (pts, cps, scales)), 1.0, 0.9)
    for k in ("loss", "cd", "l_reg", "lap"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    have = tsn.params_to_jax(tm)
    moved = 0.0
    for key, val in want.items():
        tol = 1e-5 if key.startswith("batch_stats") else 1e-4
        np.testing.assert_allclose(have[key], val, rtol=tol, atol=tol,
                                   err_msg=key)
        moved = max(moved, float(np.abs(val - init[key]).max()))
    assert moved > 1e-2   # the step is not vacuous


def test_loss_falls_over_eight_steps():
    """tests/test_pipeline.py's check of the JAX step, on the port."""
    pts, cps = make_spline_batch(np.random.RandomState(0), B, N, GRID)
    nu, nv = uniform_knot_bspline(GRID, GRID, 3, 3, 20)
    tm = tsn.SplineNet(grid=GRID, k=K, mode=0)
    tsn.init_flax_like(tm, torch.Generator().manual_seed(0))
    step, _ = tts.make_train_step(tm, tstate.make_optimizer(tm.parameters()),
                                  torch.from_numpy(nu), torch.from_numpy(nv),
                                  GRID, closed=False, anisotropic=False)
    losses = [float(step(torch.from_numpy(pts), torch.from_numpy(cps),
                         torch.ones(B, 3), 1e-3, 0.9)["loss"])
              for _ in range(8)]
    assert losses[-1] < losses[0], losses


def test_plateau_scheduler_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.91, 0.92, 0.89, 0.89, 0.9, 0.93,
               0.94, 0.88, 0.95, 0.96, 0.97, 0.98]
    j = jckpt.PlateauScheduler(1e-3, patience=2, factor=0.5, min_lr=1e-4)
    t = tckpt.PlateauScheduler(1e-3, patience=2, factor=0.5, min_lr=1e-4)
    seq = [t.step(m) for m in metrics]
    assert seq == [j.step(m) for m in metrics]
    assert min(seq) < 1e-3


def test_tree_helpers_match_jax():
    tree = {"params": {"a": {"kernel": np.ones(2)}, "b": np.zeros(1)}}
    flat = tckpt.flatten_tree(tree)
    assert flat.keys() == jckpt.flatten_tree(tree).keys()
    assert tckpt.unflatten_tree(flat).keys() == tree.keys()


def _gen(closed: bool, seed: int):
    rng = np.random.RandomState(seed)
    while True:
        pts, cps = make_spline_batch(rng, B, N, GRID, closed)
        yield tspl.canon_batch(pts, cps, False, True)


def test_run_training_saves_npz_that_loads_into_jax(tmp_path, rng):
    """2 epochs x 2 steps from generators; the best-validation npz is the
    flax layout: the JAX SplineNet fed it matches the port's model, 1e-5."""
    cfg = Config(model_path="spline_t", batch_size=B, grid_size=GRID,
                 num_epochs=2, lr=1e-3, log_dir=str(tmp_path))
    res = tts.run_training(cfg, train_gen=_gen(False, 1),
                           val_gen=_gen(False, 2), steps_per_epoch=2,
                           val_steps=1, point_buckets=(96, 128),
                           device="cpu")
    assert len(res.steps) == 4 and len(res.epochs) == 2
    assert all(np.isfinite(s["loss"]) for s in res.steps)
    lines = (tmp_path / "tensorboard" / "spline_t" / "metrics.jsonl") \
        .read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]
    path = tmp_path / "checkpoints" / "spline_t.npz"
    tree = jckpt.load_npz_params(str(path))
    assert len(_flat(tree)) == 43
    tm = tsn.SplineNet(grid=GRID, k=10, mode=0)
    tm.load_state_dict(tsn.params_from_jax(tckpt.load_npz_params(str(path)),
                                           tm))
    if np.argmin([e["val_cd"] for e in res.epochs]) == 1:
        for a, b in zip(tm.state_dict().values(),
                        res.model.state_dict().values()):
            assert torch.equal(a, b)   # the last epoch's weights were saved
    x = (rng.rand(2, 64, 3) - 0.5).astype(np.float32)
    ref = JaxSplineNet(grid=GRID, k=10, mode=0).apply(
        tree, jnp.asarray(x), train=False)
    got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_spline_dataset_batches_match_jax(tmp_path):
    """The h5 loader (splits, shuffles, canonicalisation, augmentation)
    draw for draw against the JAX package's, on a tiny h5: 1e-6."""
    pytest.importorskip("h5py")
    from parsenet_tpu.data.splines import SplineDataset as JaxDataset
    from parsenet_tpu.data.synthetic import write_spline_h5
    path = str(tmp_path / "tiny.h5")
    write_spline_h5(path, 20, num_points=64, grid=GRID, seed=3)
    jd = JaxDataset(path, 4, GRID, seed=5, splits=(12, 4))
    td = tspl.SplineDataset(path, 4, GRID, seed=5, splits=(12, 4))
    gens = [(jd.load_train_data(if_augment=True),
             td.load_train_data(if_augment=True)),
            (jd.load_val_data(anisotropic=False),
             td.load_val_data(anisotropic=False))]
    for jg, tg in gens:
        for _ in range(3):
            for a, b in zip(next(tg), next(jg)):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_align_canonical_is_the_jax_packages(rng):
    from parsenet_tpu.data.augment import align_canonical as jalign
    from parsenet_tpu_torch.data.augment import align_canonical as talign
    p = rng.randn(200, 3).astype(np.float32) * np.array([3.0, 1.0, 0.2],
                                                       np.float32)
    for aniso in (False, True):
        for a, b in zip(talign(p, p.copy(), anisotropic=aniso),
                        jalign(p, p.copy(), anisotropic=aniso)):
            np.testing.assert_array_equal(a, b)


def test_config_files_parse_as_jax(tmp_path):
    for name in ("open", "closed"):
        path = f"configs/config_{name}_splines.yml"
        assert vars(load_config(path)) == vars(jax_load_config(path))
    cfg = load_config("configs/config_open_splines.yml", lr=3e-4)
    assert (cfg.batch_size, cfg.grid_size, cfg.lr) == (36, 20, 3e-4)
    cfg.write(str(tmp_path / "c.json"))
    assert json.loads((tmp_path / "c.json").read_text())["num_points"] == 700


def test_entry_point_trains_from_the_config_h5(tmp_path):
    """python -m parsenet_tpu_torch.train.train_spline <config> --closed,
    on the CPU, from a tiny h5 named in the config. The package logger is
    first set up for another run, as an earlier test in the same process
    leaves it (test_torch_cli's entries): the run's log must still go to
    its own log_dir."""
    pytest.importorskip("h5py")
    from parsenet_tpu.data.synthetic import write_spline_h5
    from parsenet_tpu_torch.core.logging import setup_logging
    setup_logging(str(tmp_path / "earlier"), "closed_splines")
    h5 = tmp_path / "closed.h5"
    write_spline_h5(str(h5), 16, num_points=64, grid=GRID, closed=True,
                    seed=1)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(f"[train]\nmodel_path = closed_t\ndataset = {h5}\n"
                   f"num_train = 8\nnum_val = 4\nnum_epochs = 1\n"
                   f"grid_size = {GRID}\nbatch_size = 4\n"
                   f"log_dir = {tmp_path}\n")
    tts.main([str(cfg), "--closed", "--device", "cpu"])
    assert (tmp_path / "checkpoints" / "closed_t.npz").exists()
    assert (tmp_path / "configs" / "closed_splines.json").exists()
    assert os.path.getsize(tmp_path / "logs" / "closed_splines.log") > 0


def test_run_training_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.run_training(Config(grid_size=GRID), train_gen=_gen(False, 0),
                         val_gen=_gen(False, 0))
