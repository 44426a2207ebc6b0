"""Port parity: one step of the e2e trainer (train/train_e2e.make_e2e_step)
and one of the segmentation trainer (train/train_seg.make_step_fns) against
the JAX package, from the same initial weights and with the same draws, at
the size of tests/test_train_knobs.py: embedding 16, k 4, one shape of 512
points (the e2e step, decoders at grid 10 / sample grid 8), two
micro-batches of two shapes of 256 points (the seg step).

The JAX side is the loss of the JAX trainers' loss_fn, composed as they
compose it and differentiated by jax.value_and_grad; its draws come from
jax.random exactly as those trainers split their keys, and are handed to
the port. Losses and metrics within 1e-3 relative; each parameter's
gradient against JAX's by cosine >= 0.99 (the worst tensor is printed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import flatten_tree
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.fitting.pipeline import fitting_loss_shape
from parsenet_tpu.losses.embedding import primitive_nll_loss, triplet_loss
from parsenet_tpu.losses.embedding import N_PAIRS, P_SAMPLES, S_MAX
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu.models.splinenet import SplineNet as JaxSplineNet
from parsenet_tpu.ops.segmentation import mean_iou_per_class
from parsenet_tpu.train.train_e2e import build_spline_fit as jax_spline_fit
from parsenet_tpu_torch.core.guards import set_fp32_policy
from parsenet_tpu_torch.fitting.spline_apply import SplineFit
from parsenet_tpu_torch.models import splinenet as tsn
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             params_from_jax)
from parsenet_tpu_torch.train import state as tstate
from parsenet_tpu_torch.train import train_e2e as te2e
from parsenet_tpu_torch.train import train_seg as tseg

torch.set_num_threads(1)

RTOL = 1e-3
COS_MIN = 0.99


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def jax_triplet_draws(key, batch):
    """triplet_loss's uniforms for `batch` shapes from `key`, split as
    parsenet_tpu.losses.embedding splits it."""
    ups, upr = [], []
    for k in jax.random.split(key, batch):
        k_pts, k_pairs = jax.random.split(k)
        ups.append(np.asarray(jax.random.uniform(k_pts, (S_MAX, P_SAMPLES))))
        upr.append(np.asarray(jax.random.uniform(k_pairs, (N_PAIRS, 2))))
    return torch.from_numpy(np.stack(ups)), torch.from_numpy(np.stack(upr))


def port_decoders(open_vars, closed_vars, sample_grid):
    models = []
    for mode, v in ((0, open_vars), (1, closed_vars)):
        m = tsn.SplineNet(grid=10, k=10, mode=mode)
        m.load_state_dict(tsn.params_from_jax(_flat(v), m))
        models.append(m)
    return SplineFit(*models, sample_grid=sample_grid)


def _compare(metrics, ref, keys):
    for k in keys:
        got, want = float(metrics[k]), float(ref[k])
        assert abs(got - want) <= RTOL * max(abs(want), 1e-6), (k, got, want)


def _cosines(model, grads_ref):
    """{parameter: cosine of its port gradient with the JAX one}."""
    flat = _flat({"params": grads_ref})
    sd = params_from_jax(flat, model)
    out = {}
    for name, p in model.named_parameters():
        a, b = p.grad.double().ravel(), sd[name].double().ravel()
        out[name] = float(a @ b / (a.norm() * b.norm() + 1e-30))
    return out


def _check_cosines(cos):
    worst = min(cos, key=cos.get)
    print(f"worst gradient cosine: {worst} {cos[worst]:.6f}")
    assert cos[worst] >= COS_MIN, (worst, cos[worst])


def test_e2e_step_matches_jax():
    n = 512
    jmodel = JaxEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, n, 6)))["params"]
    rng = jax.random.PRNGKey(0)
    open_vars = JaxSplineNet(grid=10, k=10, mode=0).init(
        rng, jnp.zeros((1, 128, 3)), train=False)
    closed_vars = JaxSplineNet(grid=10, k=10, mode=1).init(
        rng, jnp.zeros((1, 128, 3)), train=False)
    jfit = jax_spline_fit(grid=10, sample_grid=8, open_vars=open_vars,
                          closed_vars=closed_vars)
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(0), 1, n, min_segments=2, max_segments=4)
    x = np.concatenate([pts, normals], -1).astype(np.float32)
    key = jax.random.PRNGKey(1)

    def loss_fn(p, xj, lj, pj):   # make_e2e_step's loss_fn, num_accum 1
        emb, prim_logp = jmodel.apply({"params": p}, xj)
        k1, k2 = jax.random.split(key)
        e = triplet_loss(emb, lj, k1)
        pl = primitive_nll_loss(prim_logp, pj)
        kk = jax.random.split(k2, 1)[0]
        out = fitting_loss_shape(
            xj[0, :, :3], xj[0, :, 3:6], emb[0], lj[0], pj[0], kk,
            pred_prim_per_point=jnp.argmax(prim_logp, -1)[0],
            spline_fit=jfit, lamb=0.1, ms_num_samples=256, iterations=5)
        return e + pl + out.loss, {
            "embed_loss": e, "prim_loss": pl, "res_loss": out.loss,
            "geom_loss": out.geom_loss, "spline_loss": out.spline_loss,
            "seg_iou": out.seg_iou, "prim_iou": out.prim_iou,
            "clusters": out.num_clusters.astype(jnp.float32)}

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(prim))
    k1, k2 = jax.random.split(key)
    u_pts, u_pairs = jax_triplet_draws(k1, 1)
    subset = np.asarray(jax.random.permutation(
        jax.random.split(k2, 1)[0], n))[None]

    set_fp32_policy()
    model = PrimitivesEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    model.load_state_dict(params_from_jax(_flat({"params": params}), model))
    opt = tstate.make_optimizer(model.parameters(), "adam")
    step, _ = te2e.make_e2e_step(model, port_decoders(open_vars, closed_vars,
                                                      8), opt,
                                 ms_num_samples=256)
    m = step(torch.from_numpy(x)[None], torch.from_numpy(labels)[None],
             torch.from_numpy(prim)[None],
             [te2e.E2EDraws(u_pts, u_pairs, torch.from_numpy(subset))], 1e-4)
    print({k: (float(m[k]), float(ref[k])) for k in ref})
    _compare(m, ref, ref.keys())
    assert float(m["grad_ok"]) == 1.0
    _check_cosines(_cosines(model, grads))


def test_seg_step_matches_jax():
    n, a, b = 256, 2, 2
    jmodel = JaxEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, n, 6)))["params"]
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(3), a * b, n, min_segments=2, max_segments=5)
    x = np.concatenate([pts, normals], -1).astype(np.float32).reshape(
        a, b, n, 6)
    labels, prim = labels.reshape(a, b, n), prim.reshape(a, b, n)
    keys = jax.random.split(jax.random.PRNGKey(2), a)

    def loss_fn(p, xm, lm, pm, km):   # train_seg.make_step_fns's loss_fn
        emb, prim_logp = jmodel.apply({"params": p}, xm)
        e = triplet_loss(emb, lm, km)
        pl = primitive_nll_loss(prim_logp, pm)
        return e + pl, {"embed_loss": e, "prim_loss": pl,
                        "miou": mean_iou_per_class(pm, prim_logp)}

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    ref, grads = None, None
    for i in range(a):
        (_, m), g = vg(params, jnp.asarray(x[i]), jnp.asarray(labels[i]),
                       jnp.asarray(prim[i]), keys[i])
        ref = m if ref is None else jax.tree_util.tree_map(jnp.add, ref, m)
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    ref = {k: v / a for k, v in ref.items()}
    grads = jax.tree_util.tree_map(lambda g: g * (1.0 / a), grads)
    draws = [jax_triplet_draws(k, b) for k in keys]

    set_fp32_policy()
    model = PrimitivesEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    model.load_state_dict(params_from_jax(_flat({"params": params}), model))
    opt = tstate.make_optimizer(model.parameters(), "adam")
    step, _ = tseg.make_step_fns(model, opt)
    m = step(torch.from_numpy(x), torch.from_numpy(labels),
             torch.from_numpy(prim), torch.stack([d[0] for d in draws]),
             torch.stack([d[1] for d in draws]), 0.01)
    print({k: (float(m[k]), float(ref[k])) for k in ref})
    _compare(m, ref, ref.keys())
    assert float(m["grad_ok"]) == 1.0
    _check_cosines(_cosines(model, grads))


@pytest.mark.parametrize("trainer", ["seg", "e2e"])
def test_main_refuses_a_missing_h5(tmp_path, trainer):
    """The entry points read the config's h5 and fail without it; no
    synthetic data is substituted. Without --device they take the card,
    and raise where there is none."""
    cfg = tmp_path / "c.yml"
    cfg.write_text(f"[train]\nmodel_path = \"m\"\ndataset = \"{tmp_path}/\"\n"
                   f"batch_size = 1\nmode = 5\nnum_epochs = 1\n"
                   f"log_dir = \"{tmp_path}/logs\"\n")
    main = tseg.main if trainer == "seg" else te2e.main
    with pytest.raises((FileNotFoundError, OSError)):
        main([str(cfg), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([str(cfg)])
