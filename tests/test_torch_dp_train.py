"""Port parity: the data-parallel trainers. One step under a group of W = 2
gloo ranks (parallel.launch.spawn: spawn start method, a FileStore under
tmp_path, one torch thread a rank, a 120 s deadline) against the one-rank
step of the same global batch, and against the JAX trainers' step on
make_mesh(2) of the 8-device CPU mesh (the JAX side computed here, in the
parent, and handed over as numpy).

Tolerances. W = 2 against W = 1: step-1 metrics within 1e-5 relative, each
gradient within 1e-5 max|ref| + 1e-7, SplineNet's running statistics
within 1e-6. Against JAX on make_mesh(2): those of the existing one-device
parity tests of the same step (tests/test_torch_train_e2e.py for the
segmentation step: 1e-3 relative and gradient cosines >= 0.99;
tests/test_torch_train_spline.py for the SplineNet step: metrics 1e-4,
batch statistics 1e-5, parameters after the step 1e-4).

The segmentation batch gives the two ranks different numbers of
multi-segment shapes (rank 0 two, rank 1 one): the triplet loss's
normaliser is the global count, where a mean of the ranks' own losses
would be off by far more than 1e-5.
"""
import os

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.core.config import Config
from parsenet_tpu_torch.data import splines as tspl
from parsenet_tpu_torch.data.synthetic import make_shape_batch, make_spline_batch
from parsenet_tpu_torch.fitting.spline_apply import SplineFit
from parsenet_tpu_torch.losses.embedding import triplet_loss
from parsenet_tpu_torch.models import splinenet as tsn
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             init_flax_like, params_from_jax)
from parsenet_tpu_torch.parallel import launch
from parsenet_tpu_torch.parallel.mesh import shard_batch
from parsenet_tpu_torch.train import state as tstate
from parsenet_tpu_torch.train import train_e2e as te2e
from parsenet_tpu_torch.train import train_seg as tseg
from parsenet_tpu_torch.train import train_spline as tts

torch.set_num_threads(1)

DEADLINE = 120.0
N_SEG = 256
GRID, K, B, N = 8, 4, 4, 128


def _grads(model):
    return {n: p.grad.detach().numpy().copy()
            for n, p in model.named_parameters()}


def _close_grads(got, ref):
    for name, g in ref.items():
        tol = 1e-5 * float(np.abs(g).max()) + 1e-7
        assert float(np.abs(got[name] - g).max()) <= tol, name


def _close_metrics(got, ref, keys, rtol=1e-5):
    for k in keys:
        assert abs(got[k] - ref[k]) <= rtol * max(abs(ref[k]), 1e-6), (
            k, got[k], ref[k])


# --- segmentation step ------------------------------------------------------

def _seg_batch():
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(3), 4, N_SEG, min_segments=2, max_segments=5)
    labels[2] = 0                  # one single-segment shape, on rank 1
    x = np.concatenate([pts, normals], -1).astype(np.float32)[None]
    return x, labels[None], prim[None]


def _seg_step(mesh, init, x, labels, prim, u_pts, u_pairs):
    """One seg step on this rank's slice -> (metrics, grads, the rank's
    own triplet loss, normalised by its own count)."""
    model = PrimitivesEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    model.load_state_dict(params_from_jax(init, model))
    step, _ = tseg.make_step_fns(
        model, tstate.make_optimizer(model.parameters(), "adam"), mesh)
    batch = [shard_batch(mesh, torch.from_numpy(a), axis=1)
             for a in (x, labels, prim, u_pts, u_pairs)]
    with torch.no_grad():
        own = float(triplet_loss(model(batch[0][0])[0], batch[1][0],
                                 batch[3][0], batch[4][0]))
    m = step(*batch, 0.01)
    return {k: float(v) for k, v in m.items()}, _grads(model), own


def test_seg_step_two_ranks_equal_one_and_the_jax_mesh(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from test_torch_train_e2e import (COS_MIN, RTOL, _flat,
                                      jax_triplet_draws)
    from parsenet_tpu.losses.embedding import (primitive_nll_loss,
                                               triplet_loss as j_triplet)
    from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
    from parsenet_tpu.ops.segmentation import mean_iou_per_class
    from parsenet_tpu.parallel.mesh import DATA_AXIS, make_mesh

    x, labels, prim = _seg_batch()
    jmodel = JaxEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, N_SEG, 6)))["params"]
    init = _flat({"params": params})
    key = jax.random.split(jax.random.PRNGKey(2), 1)[0]
    u_pts, u_pairs = (d.numpy()[None] for d in jax_triplet_draws(key, 4))

    def loss_fn(p, xm, lm, pm):     # train_seg.make_step_fns's loss_fn
        emb, prim_logp = jmodel.apply({"params": p}, xm)
        e = j_triplet(emb, lm, key)
        pl = primitive_nll_loss(prim_logp, pm)
        return e + pl, {"embed_loss": e, "prim_loss": pl,
                        "miou": mean_iou_per_class(pm, prim_logp)}

    jm = make_mesh(2)
    bsh = NamedSharding(jm, P(DATA_AXIS))
    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, *(jax.device_put(a[0], bsh) for a in (x, labels, prim)))

    one = _seg_step(None, init, x, labels, prim, u_pts, u_pairs)
    two = launch.spawn(_seg_step, 2,
                       (init, x, labels, prim, u_pts, u_pairs),
                       device="cpu", deadline=DEADLINE,
                       store_dir=str(tmp_path))
    keys = ("embed_loss", "prim_loss", "miou")
    for m, g, _ in two:
        _close_metrics(m, one[0], keys)
        _close_grads(g, one[1])
        assert m["grad_ok"] == 1.0
    # the normaliser: each rank's own mean, averaged, is far off
    naive = np.mean([t[2] for t in two])
    assert abs(naive - one[0]["embed_loss"]) > 10 * 1e-5 * abs(naive)
    # against the JAX step on make_mesh(2)
    m, g, _ = two[0]
    for k in keys:
        assert abs(m[k] - float(ref[k])) <= RTOL * max(abs(float(ref[k])),
                                                        1e-6), k
    want = params_from_jax(_flat({"params": jgrads}), PrimitivesEmbedding(
        emb_size=16, num_primitives=10, mode=5, k=4))
    for name, gr in g.items():
        a, b = gr.ravel().astype(np.float64), want[name].double().numpy().ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
        assert cos >= COS_MIN, (name, cos)


# --- SplineNet step ---------------------------------------------------------

def _spline_step(mesh, init, nu, nv, pts, cps, scales, closed):
    """One SGD (lr 1) step on this rank's slice -> (metrics, the flat
    state after the step, grads)."""
    tm = tsn.SplineNet(grid=GRID, k=K, mode=int(closed))
    tm.load_state_dict(tsn.params_from_jax(init, tm))
    step, _ = tts.make_train_step(
        tm, tstate.make_optimizer(tm.parameters(), "sgd"),
        torch.from_numpy(nu), torch.from_numpy(nv), GRID, closed, True, mesh)
    got = step(*shard_batch(mesh, tuple(map(torch.from_numpy,
                                            (pts, cps, scales)))), 1.0, 0.9)
    return ({k: float(v) for k, v in got.items()}, tsn.params_to_jax(tm),
            _grads(tm))


@pytest.mark.parametrize("closed", [False, True])
def test_spline_step_two_ranks_equal_one_and_the_jax_mesh(tmp_path, closed):
    import jax
    import jax.numpy as jnp
    from parsenet_tpu.models.splinenet import SplineNet as JaxSplineNet
    from parsenet_tpu.ops.bspline import uniform_knot_bspline
    from parsenet_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                            replicate)
    from parsenet_tpu.train import state as jstate
    from parsenet_tpu.train import train_spline as jts
    from test_torch_train_spline import _batch, _flat

    pts, cps, scales = _batch(closed)
    nu, nv = uniform_knot_bspline(GRID, GRID, 3, 3, 40)
    jm = JaxSplineNet(grid=GRID, k=K, mode=int(closed))
    state = jstate.create_state(jm, jax.random.PRNGKey(0),
                                (jnp.zeros((B, N, 3)),), optimizer="sgd",
                                train=True)
    init = _flat({"params": state.params, "batch_stats": state.batch_stats})
    mesh = make_mesh(2)
    j_step, _ = jts.make_train_step(jm, jnp.asarray(nu), jnp.asarray(nv),
                                    GRID, closed, True)
    bsh = batch_sharding(mesh)
    new_state, ref = j_step(replicate(mesh, state),
                            *(jax.device_put(a, bsh)
                              for a in (pts, cps, scales)),
                            jnp.float32(1.0), jnp.float32(0.9))
    want = _flat({"params": new_state.params,
                  "batch_stats": new_state.batch_stats})

    args = (init, nu, nv, pts, cps, scales, closed)
    one = _spline_step(None, *args)
    two = launch.spawn(_spline_step, 2, args, device="cpu",
                       deadline=DEADLINE, store_dir=str(tmp_path))
    stats = [k for k in one[1] if k.startswith("batch_stats")]
    for m, state_after, g in two:
        _close_metrics(m, one[0], ("loss", "cd", "l_reg", "lap"))
        _close_grads(g, one[2])
        for k in stats:
            np.testing.assert_allclose(state_after[k], one[1][k], rtol=0,
                                       atol=1e-6, err_msg=k)
    for k in stats:    # every rank keeps the same running statistics
        np.testing.assert_array_equal(two[0][1][k], two[1][1][k])
    for k in ("loss", "cd", "l_reg", "lap"):
        np.testing.assert_allclose(two[0][0][k], float(ref[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    for key, val in want.items():
        tol = 1e-5 if key.startswith("batch_stats") else 1e-4
        np.testing.assert_allclose(two[0][1][key], val, rtol=tol, atol=tol,
                                   err_msg=key)


# --- e2e step -----------------------------------------------------------------

def _e2e_step(mesh, x, labels, prim):
    """One e2e step (embedding 16, k 4, decoders at grid 10 / sample grid
    8 from a seeded flax-style init) on this rank's slice."""
    model = PrimitivesEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    init_flax_like(model, torch.Generator().manual_seed(0))
    decoders = []
    for mode in (0, 1):
        m = tsn.SplineNet(grid=10, k=10, mode=mode)
        tsn.init_flax_like(m, torch.Generator().manual_seed(mode))
        decoders.append(m.eval())
    step, _ = te2e.make_e2e_step(
        model, SplineFit(*decoders, sample_grid=8),
        tstate.make_optimizer(model.parameters(), "adam"),
        ms_num_samples=N_SEG, mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    draws = te2e.draw_e2e(x.shape[0], x.shape[1], N_SEG, gen)
    m = step(*(shard_batch(mesh, torch.from_numpy(a))[None]
               for a in (x, labels, prim)), [shard_batch(mesh, draws)], 1e-4)
    return {k: float(v) for k, v in m.items()}, _grads(model)


def test_e2e_step_two_ranks_equal_one(tmp_path):
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(0), 2, N_SEG, min_segments=2, max_segments=4)
    x = np.concatenate([pts, normals], -1).astype(np.float32)
    one = _e2e_step(None, x, labels, prim)
    two = launch.spawn(_e2e_step, 2, (x, labels, prim), device="cpu",
                       deadline=DEADLINE, store_dir=str(tmp_path))
    for m, g in two:
        _close_metrics(m, one[0], te2e.METRICS)
        _close_grads(g, one[1])
        assert m["grad_ok"] == 1.0


# --- the trainers' loops -----------------------------------------------------

def _spline_gen(seed):
    rng = np.random.RandomState(seed)
    while True:
        pts, cps = make_spline_batch(rng, B, N, GRID, False)
        yield tspl.canon_batch(pts, cps, False, True)


def _spline_run(mesh, log_dir, num_devices):
    cfg = Config(model_path="dp", batch_size=B, grid_size=GRID,
                 num_epochs=1, lr=1e-3, log_dir=log_dir,
                 num_devices=num_devices)
    res = tts.run_training(cfg, train_gen=_spline_gen(1),
                           val_gen=_spline_gen(2), steps_per_epoch=2,
                           val_steps=1, point_buckets=(96, 128),
                           device="cpu", mesh=mesh)
    return res.steps, res.epochs


def _spline_run_in_rank(mesh, log_dir):
    # the trainer makes its own mesh from config.num_devices, joining the
    # launched group
    return _spline_run(None, log_dir, 2)


def test_spline_trainer_loop_over_two_ranks(tmp_path):
    """run_training with num_devices 2 in each of 2 ranks equals the
    one-rank run of the same batches: step 1 within 1e-5; the second step
    and the validation after Adam's steps within 1e-3 (Adam's first steps
    turn round-off gradients, about 1e-8, into steps of a full lr of
    either sign: tests/test_torch_train_spline.py). Only rank 0 writes
    files, and both ranks take one validation decision."""
    one_dir, two_dir = tmp_path / "one", tmp_path / "two"
    steps1, epochs1 = _spline_run(None, str(one_dir), 0)
    two = launch.spawn(_spline_run_in_rank, 2, (str(two_dir),), device="cpu",
                       deadline=DEADLINE, store_dir=str(tmp_path))
    keys = ("loss", "cd", "l_reg", "lap")
    for steps, epochs in two:
        _close_metrics(steps[0], steps1[0], keys)
        _close_metrics(steps[1], steps1[1], keys, rtol=1e-3)
        _close_metrics(epochs[0], epochs1[0], ("val_cd",), rtol=1e-3)
    assert two[0][1] == two[1][1]       # one validation decision
    assert os.path.exists(two_dir / "checkpoints" / "dp.npz")
    lines = (two_dir / "tensorboard" / "dp" / "metrics.jsonl").read_text()
    assert len(lines.splitlines()) == 1  # rank 0's line alone


def test_trainer_rejects_a_num_devices_it_cannot_honour(tmp_path):
    with pytest.raises(RuntimeError, match="torchrun"):
        _spline_run(None, str(tmp_path), 2)
    assert not torch.distributed.is_initialized()
