"""Port parity: one half_precision step of the e2e trainer (the bf16
network of models.dgcnn) against the JAX trainer's bf16 step, on
tests/test_torch_train_e2e.py's 512-point shape, weights and draws,
without decoders; the JAX reference compiled with XLA's excess precision
off (test_torch_half_precision_steps.strict_jit). Tolerances and what was
measured: test_torch_half_precision_steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.losses.embedding import primitive_nll_loss, triplet_loss
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu_torch.core.guards import set_fp32_policy
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             params_from_jax)
from parsenet_tpu_torch.train import state as tstate
from parsenet_tpu_torch.train import train_e2e as te2e
from test_torch_half_precision_steps import BF16, _hp_compare, strict_jit
from test_torch_train_e2e import _flat, jax_triplet_draws

torch.set_num_threads(1)


ABLATE = ("ms",)


def test_half_precision_e2e_step_matches_jax():
    """The e2e step without decoders (the fitting loss's geometric part),
    one shape of 512 points, on the GT segments (the `ms` arm): at 512
    points the mean-shift's cluster count is decided by differences of
    bf16 rounding order (3 clusters in the port, 2 in the JAX package on
    these weights), and a count apart makes every loss another."""
    from parsenet_tpu.fitting.pipeline import fitting_loss_shape
    n = 512
    jmodel = JaxEmbedding(emb_size=16, num_primitives=10, mode=5, k=4,
                          dtype=jnp.bfloat16, gather_bf16=True)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, n, 6)))["params"]
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
            spline_fit=None, lamb=0.1, ms_num_samples=256, iterations=5,
            ablate=ABLATE)
        return e + pl + out.loss, {
            "embed_loss": e, "prim_loss": pl, "res_loss": out.loss,
            "geom_loss": out.geom_loss, "seg_iou": out.seg_iou,
            "clusters": out.num_clusters.astype(jnp.float32)}

    args = (params, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(prim))
    (_, ref), grads = strict_jit(jax.value_and_grad(loss_fn, has_aux=True),
                                 *args)(*args)
    k1, k2 = jax.random.split(key)
    u_pts, u_pairs = jax_triplet_draws(k1, 1)
    subset = np.asarray(jax.random.permutation(
        jax.random.split(k2, 1)[0], n))[None]

    set_fp32_policy()
    model = PrimitivesEmbedding(emb_size=16, num_primitives=10, mode=5, k=4,
                                **BF16)
    model.load_state_dict(params_from_jax(_flat({"params": params}), model))
    opt = tstate.make_optimizer(model.parameters(), "adam")
    step, _ = te2e.make_e2e_step(model, None, opt, ms_num_samples=256,
                                 ablate=ABLATE)
    m = step(torch.from_numpy(x)[None], torch.from_numpy(labels)[None],
             torch.from_numpy(prim)[None],
             [te2e.E2EDraws(u_pts, u_pairs, torch.from_numpy(subset))], 1e-4)
    _hp_compare(m, ref, grads, model, "e2e")
