"""Port parity: the spline-free inference slice end to end.

predict_segmentation -> reconstruct_shape(spline_fit=None) on 2 shapes x
1024 points with the shipped params, k = 80, through the JAX package and
through parsenet_tpu_torch on the CPU (plain kernel versions), with the same
bandwidth subset and coverage uniforms on both sides.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import load_npz_params as jax_load_npz
from parsenet_tpu.data.abc import normalize_points
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.eval import pipeline as jp
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")
N, B, SUBSET = 1024, 2, 512


def canonical(labels):
    """Cluster ids renumbered by first appearance: two clusterings are the
    same partition iff their canonical forms are equal. Which point of a
    converged mode names its cluster rides on last-bit differences of the
    shifted embedding, so the numbering itself is not compared."""
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    rename = {int(labels[f]): r for r, f in enumerate(np.sort(first))}
    return np.array([rename[int(v)] for v in labels])


@pytest.fixture(scope="module")
def slice_runs():
    pts, lab, nrm, prim = make_shape_batch(np.random.RandomState(7), B, N)
    for i in range(B):
        pts[i], nrm[i], _, _ = normalize_points(pts[i], nrm[i])
    pts, nrm = pts.astype(np.float32), nrm.astype(np.float32)

    jmodel = JaxEmbedding(emb_size=128, num_primitives=10, mode=5, k=80)
    jparams = jax_load_npz(PARAMS)["params"]
    apply_fn = jax.jit(lambda x: jmodel.apply({"params": jparams}, x))
    tmodel = load_primitives_embedding(PARAMS, device="cpu")

    jax_out, subsets, uniforms = [], [], []
    for i in range(B):
        k1, k2 = jax.random.split(jax.random.PRNGKey(100 + i))
        x = jnp.concatenate([pts[i], nrm[i]], axis=-1)
        pred = jp.predict_segmentation(apply_fn, x, jnp.asarray(lab[i]),
                                       jnp.asarray(prim[i]), k1,
                                       ms_num_samples=SUBSET)
        rec = jp.reconstruct_shape(jnp.asarray(pts[i]), jnp.asarray(nrm[i]),
                                   pred.labels, pred.pred_prim, k2,
                                   spline_fit=None)
        jax_out.append((pred, rec))
        subsets.append(np.asarray(jax.random.permutation(k1, N)[:SUBSET]))
        uniforms.append(np.asarray(jax.random.uniform(
            jax.random.fold_in(k2, 7), (jp.COV_SAMPLES,))))

    tpred = tp.predict_segmentation(tmodel, pts, nrm, lab, prim,
                                    ms_num_samples=SUBSET,
                                    subsets=torch.from_numpy(np.stack(subsets)),
                                    device="cpu")
    # the port end to end, and the port's reconstruction on the JAX labels:
    # the coverage draw walks the segments in id order, so p_cov / sk_2 are
    # compared on one numbering
    trec, trec_jl = [], []
    for i in range(B):
        u = torch.from_numpy(uniforms[i].copy())
        trec.append(tp.reconstruct_shape(pts[i], nrm[i], tpred.labels[i],
                                         tpred.pred_prim[i], uniforms=u,
                                         device="cpu"))
        trec_jl.append(tp.reconstruct_shape(
            pts[i], nrm[i], np.asarray(jax_out[i][0].labels),
            np.asarray(jax_out[i][0].pred_prim), uniforms=u, device="cpu"))
    return jax_out, tpred, trec, trec_jl


def test_segmentation_matches(slice_runs):
    jax_out, tpred, _, _ = slice_runs
    for i, (pred, _) in enumerate(jax_out):
        np.testing.assert_array_equal(canonical(tpred.labels[i]),
                                      canonical(pred.labels))
        np.testing.assert_array_equal(tpred.pred_prim[i].numpy(),
                                      np.asarray(pred.pred_prim))
        assert tpred.num_clusters[i] == int(pred.num_clusters)
        np.testing.assert_allclose(float(tpred.seg_iou[i]),
                                   float(pred.seg_iou), atol=1e-4)
        np.testing.assert_allclose(float(tpred.prim_iou[i]),
                                   float(pred.prim_iou), atol=1e-4)


def test_reconstruction_matches(slice_runs):
    jax_out, _, trec, trec_jl = slice_runs
    for (_, rec), t, tj in zip(jax_out, trec, trec_jl):
        np.testing.assert_allclose(float(t.residual), float(rec.residual),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tj.residual), float(rec.residual),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tj.p_cov), float(rec.p_cov),
                                   atol=1e-3)
        np.testing.assert_allclose(float(tj.sk_2), float(rec.sk_2),
                                   atol=1e-3)
        np.testing.assert_array_equal(np.sort(t.surface_mask.numpy()),
                                      np.sort(np.asarray(rec.surface_mask)))
