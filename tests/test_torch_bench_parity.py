"""Port parity: the inference arms that the bench's BENCH_ABLATE drives,
against the JAX package's eval pipeline on the CPU.

* predict_segmentation(skip_siou=True): 2 shapes x 512 points of stream a,
  the shipped weights at k 16, the JAX package's bandwidth subsets handed
  to the port: the same partition and cluster count, seg_iou = prim_iou =
  1 on both sides.
* reconstruct_shape(profile_skip=...): the spline-free reconstruction of 2
  stream-a shapes of 2,048 points on their GT segments and types, the JAX
  package's coverage uniforms: the skipped section 0 on both sides, the
  others as test_torch_spline_slots holds them (residual and p_cov 1e-3
  relative, sk_1 and sk_2 1e-3 absolute: 2 of the 2,048 points).
(reconstruct_shape(eval_preprocess=False) is held in
tests/test_torch_bench_preprocess.py.)
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
from test_torch_slice import canonical

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")
TOL = {"residual": {"rtol": 1e-3}, "p_cov": {"rtol": 1e-3},
       "sk_1": {"rtol": 0, "atol": 1e-3}, "sk_2": {"rtol": 0, "atol": 1e-3}}


def _stream_a(n, b=2):
    pts, lab, nrm, prim = make_shape_batch(np.random.RandomState(7), b, n)
    for i in range(b):
        pts[i], nrm[i], _, _ = normalize_points(pts[i], nrm[i])
    return pts.astype(np.float32), lab, nrm.astype(np.float32), prim


def test_skip_siou_matches_jax():
    n, k, subset = 512, 16, 256
    pts, lab, nrm, prim = _stream_a(n)
    jmodel = JaxEmbedding(emb_size=128, num_primitives=10, mode=5, k=k)
    jparams = jax_load_npz(PARAMS)["params"]
    apply_fn = jax.jit(lambda x: jmodel.apply({"params": jparams}, x))
    refs, subsets = [], []
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        refs.append(jp.predict_segmentation(
            apply_fn, jnp.concatenate([pts[i], nrm[i]], -1),
            jnp.asarray(lab[i]), jnp.asarray(prim[i]), key,
            ms_num_samples=subset, skip_siou=True))
        subsets.append(np.asarray(jax.random.permutation(key, n)[:subset]))
    got = tp.predict_segmentation(
        load_primitives_embedding(PARAMS, k=k, device="cpu"), pts, nrm, lab,
        prim, ms_num_samples=subset, skip_siou=True,
        subsets=torch.from_numpy(np.stack(subsets)), device="cpu")
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(canonical(got.labels[i]),
                                      canonical(ref.labels))
        assert got.num_clusters[i] == int(ref.num_clusters)
        assert float(ref.seg_iou) == float(ref.prim_iou) == 1.0
        assert float(got.seg_iou[i]) == float(got.prim_iou[i]) == 1.0


@pytest.mark.parametrize("skip", [("residual",), ("coverage",)],
                         ids=["residual", "coverage"])
def test_profile_skip_matches_jax(skip):
    pts, lab, nrm, prim = _stream_a(2048)
    for i in range(2):
        key = jax.random.PRNGKey(300 + i)
        ref = jp.reconstruct_shape(jnp.asarray(pts[i]), jnp.asarray(nrm[i]),
                                   jnp.asarray(lab[i]), jnp.asarray(prim[i]),
                                   key, spline_fit=None, profile_skip=skip)
        u = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7),
                                          (jp.COV_SAMPLES,)))
        got = tp.reconstruct_shape(pts[i], nrm[i], lab[i], prim[i],
                                   uniforms=torch.from_numpy(u),
                                   profile_skip=skip, device="cpu")
        for k, tol in TOL.items():
            want = float(getattr(ref, k))
            zero = ("residual" in skip and k == "residual") or (
                "coverage" in skip and k != "residual")
            assert (want == 0.0) == zero, (k, want)
            if zero:
                assert float(getattr(got, k)) == 0.0, k
            else:
                np.testing.assert_allclose(float(getattr(got, k)), want,
                                           **tol)


def test_profile_skip_rejects_other_sections():
    with pytest.raises(ValueError, match="profile_skip"):
        tp.reconstruct_shape(np.zeros((8, 3), np.float32),
                             np.zeros((8, 3), np.float32),
                             np.zeros(8, np.int64), np.zeros(8, np.int64),
                             uniforms=torch.zeros(tp.COV_SAMPLES),
                             profile_skip=("splines",), device="cpu")
