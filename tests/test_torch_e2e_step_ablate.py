"""Port parity: make_e2e_step's stage-costing arms (netgrad: the network's
outputs detached; fit: no fitting loss) against the JAX trainer's loss_fn
with the same arm, at tests/test_torch_train_e2e.py's size, weights and
draws, without decoders (the arms act on the network's outputs, not on
the slots). Losses and metrics within its 1e-3 relative. netgrad:
every parameter's gradient is zero in both (the port's backward still runs
the fitting loss down to the detached outputs, which is what its time
prices); fit: each gradient by cosine >= 0.99 (the triplet and NLL terms
only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.fitting.pipeline import FittingLossOut, fitting_loss_shape
from parsenet_tpu.losses.embedding import primitive_nll_loss, triplet_loss
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu_torch.core.guards import set_fp32_policy
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             params_from_jax)
from parsenet_tpu_torch.train import state as tstate
from parsenet_tpu_torch.train import train_e2e as te2e
from test_torch_train_e2e import (_check_cosines, _compare, _cosines, _flat,
                                  jax_triplet_draws)

torch.set_num_threads(1)


@pytest.mark.parametrize("arm", ["netgrad", "fit"])
def test_e2e_step_arm_matches_jax(arm):
    n = 512
    jmodel = JaxEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, n, 6)))["params"]
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(0), 1, n, min_segments=2, max_segments=4)
    x = np.concatenate([pts, normals], -1).astype(np.float32)
    key = jax.random.PRNGKey(1)

    def loss_fn(p, xj, lj, pj):   # make_e2e_step's loss_fn with the arm
        emb, prim_logp = jmodel.apply({"params": p}, xj)
        if arm == "netgrad":
            emb = jax.lax.stop_gradient(emb)
            prim_logp = jax.lax.stop_gradient(prim_logp)
        k1, k2 = jax.random.split(key)
        e = triplet_loss(emb, lj, k1)
        pl = primitive_nll_loss(prim_logp, pj)
        if arm == "fit":
            z = jnp.zeros(())
            out = FittingLossOut(z + jnp.mean(emb) * 0.0, z, z, z, z,
                                 jnp.int32(0))
        else:
            kk = jax.random.split(k2, 1)[0]
            out = fitting_loss_shape(
                xj[0, :, :3], xj[0, :, 3:6], emb[0], lj[0], pj[0], kk,
                pred_prim_per_point=jnp.argmax(prim_logp, -1)[0],
                spline_fit=None, lamb=0.1, ms_num_samples=256, iterations=5)
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
    step, _ = te2e.make_e2e_step(model, None, opt, ms_num_samples=256,
                                 ablate=(arm,))
    m = step(torch.from_numpy(x)[None], torch.from_numpy(labels)[None],
             torch.from_numpy(prim)[None],
             [te2e.E2EDraws(u_pts, u_pairs, torch.from_numpy(subset))], 1e-4)
    print({k: (float(m[k]), float(ref[k])) for k in ref})
    _compare(m, ref, ref.keys())
    assert float(m["grad_ok"]) == 1.0
    if arm == "netgrad":
        assert all(not np.asarray(g).any()
                   for g in jax.tree_util.tree_leaves(grads))
        assert all(not q.grad.any() for q in model.parameters())
    else:
        assert float(m["res_loss"]) == 0.0
        _check_cosines(_cosines(model, grads))


def test_unknown_step_arm_raises():
    model = PrimitivesEmbedding(emb_size=16, mode=5, k=4)
    opt = tstate.make_optimizer(model.parameters(), "adam")
    with pytest.raises(ValueError, match="ablate"):
        te2e.make_e2e_step(model, None, opt, ablate=("splines",))
