"""Port parity: reconstruct_shape(eval_preprocess=False), the bench's
BENCH_ABLATE=preprocess arm, against the JAX package's on
test_torch_spline_slots's staged shape 0 (2,048 points, 4 slots, the
shipped decoders), the JAX package's with-replacement uniforms handed to
the port: the sampled slot points equal, the metrics at the slot test's
tolerances (residual and p_cov 1e-3 relative, sk_1 and sk_2 1e-3
absolute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from parsenet_tpu.eval import pipeline as jp
from parsenet_tpu.train.train_e2e import build_spline_fit as jax_spline_fit
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.fitting import spline_apply as sa
from test_torch_bench_parity import TOL
from test_torch_spline_slots import _staged_inputs

torch.set_num_threads(1)


def test_eval_preprocess_false_matches_jax():
    pts, nrm, labels, prim = _staged_inputs()
    slots, i = 4, 0
    key = jax.random.PRNGKey(200)
    ref = jp.reconstruct_shape(jnp.asarray(pts[i]), jnp.asarray(nrm[i]),
                               jnp.asarray(labels[i]), jnp.asarray(prim[i]),
                               key, spline_fit=jax_spline_fit(grid=20),
                               max_spline_slots=slots, eval_preprocess=False)
    # the JAX package's draws: one key a slot, SPLINE_PTS uniforms each
    keys = jax.random.split(key, slots)
    u = np.stack([np.asarray(jax.random.uniform(kk, (jp.SPLINE_PTS,)))
                  for kk in keys])
    u_cov = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7),
                                          (jp.COV_SAMPLES,)))
    got = tp.reconstruct_shape(
        pts[i], nrm[i], labels[i], prim[i], uniforms=torch.from_numpy(u_cov),
        spline_fit=sa.build_spline_fit(device="cpu"),
        slot_uniforms=torch.from_numpy(u), eval_preprocess=False,
        device="cpu")
    # the with-replacement samples themselves, for each slot's segment
    counts = torch.from_numpy(np.bincount(labels[i], minlength=50)
                              .astype(np.float32))
    segs = np.array([3, 4, 2, 0])    # the staged shape's slots
    mine = tp.sample_segment_points(torch.from_numpy(pts[i]),
                                    torch.from_numpy(labels[i]
                                                     .astype(np.int64)),
                                    counts, torch.from_numpy(segs),
                                    torch.from_numpy(u)).numpy()
    for s, (g, kk) in enumerate(zip(segs, keys)):
        np.testing.assert_array_equal(mine[s], np.asarray(
            jp._sample_segment_points(jnp.asarray(pts[i]),
                                      jnp.asarray(labels[i]), g,
                                      jp.SPLINE_PTS, kk)))
    for k, tol in TOL.items():
        print(f"{k}: port {float(getattr(got, k)):.6g} JAX "
              f"{float(getattr(ref, k)):.6g}")
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(ref, k)), **tol)
