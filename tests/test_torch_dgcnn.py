"""Port parity: exact kNN and the DGCNN embedding network."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import flatten_tree
from parsenet_tpu.core.checkpoint import load_npz_params as jax_load_npz
from parsenet_tpu.data.abc import normalize_points
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu.ops import knn as jknn
from parsenet_tpu_torch.core.checkpoint import load_npz_params
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             load_primitives_embedding,
                                             params_from_jax)
from parsenet_tpu_torch.ops import knn as tknn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")


def _sets(idx):
    return [set(row) for row in np.asarray(idx).reshape(-1, idx.shape[-1])]


def _shapes(n, b=2, seed=13):
    pts, _, nrm, _ = make_shape_batch(np.random.RandomState(seed), b, n)
    for i in range(b):
        pts[i], nrm[i], _, _ = normalize_points(pts[i], nrm[i])
    return np.concatenate([pts, nrm], -1).astype(np.float32)


@pytest.mark.parametrize("k2", [16, 32])
def test_knn_features_same_sets(rng, k2):
    x = rng.randn(2, 512, 8).astype(np.float32)
    ref = jknn.knn(jnp.asarray(x), k1=16, k2=k2, exact=True)
    got = tknn.knn(torch.from_numpy(x), k1=16, k2=k2)
    assert got.shape == (2, 512, 16)
    assert _sets(got.numpy()) == _sets(ref)


def test_knn_points_normals_same_sets():
    x = _shapes(512)
    ref = jknn.knn_points_normals(jnp.asarray(x), k1=16, k2=16, exact=True)
    got = tknn.knn_points_normals(torch.from_numpy(x), k1=16, k2=16)
    assert _sets(got.numpy()) == _sets(ref)


def test_gather_neighbors(rng):
    x = rng.randn(2, 40, 5).astype(np.float32)
    idx = rng.randint(0, 40, (2, 40, 7))
    ref = jknn.gather_neighbors(jnp.asarray(x), jnp.asarray(idx))
    got = tknn.gather_neighbors(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_shipped_params_carry_across():
    flat = load_npz_params(PARAMS)
    assert len(flat) == 36
    model = PrimitivesEmbedding(mode=5, k=80)
    sd = params_from_jax(flat, model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    w = flat["params/encoder/conv1/w_diff/kernel"]
    np.testing.assert_array_equal(
        model.encoder.conv1.w_diff.weight.detach().numpy(), w.T)


def test_params_from_jax_rejects_leftovers():
    flat = load_npz_params(PARAMS)
    model = PrimitivesEmbedding(mode=5, k=80)
    extra = dict(flat, **{"params/extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="unused"):
        params_from_jax(extra, model)
    missing = dict(flat)
    del missing["params/bn1/scale"]
    with pytest.raises(KeyError, match="unset"):
        params_from_jax(missing, model)


def _assert_embedding_close(e, ref):
    """Raw embeddings reach |e| ~ 500, and float32 sums taken in another
    order differ by ~1e-6 of that scale, so the absolute floor is 1e-4 of
    the largest magnitude; the unit-normalised embeddings that mean-shift
    reads are held to 1e-4 absolute."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(e, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    unit = lambda v: v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
    np.testing.assert_allclose(unit(e), unit(ref), rtol=1e-4, atol=1e-4)


def test_embedding_mode5_shipped_params():
    # seed 13: on seed 7's second shape a layer-2 neighbour sits 2e-6
    # (relative) from the 80th, so last-bit differences swap it, and the
    # global max-pool carries that swap to every point
    x = _shapes(1024)
    jmodel = JaxEmbedding(emb_size=128, num_primitives=10, mode=5, k=80)
    ref_e, ref_p = jmodel.apply({"params": jax_load_npz(PARAMS)["params"]},
                                jnp.asarray(x))
    model = load_primitives_embedding(PARAMS, mode=5, k=80, device="cpu")
    with torch.no_grad():
        e, p = model(torch.from_numpy(x))
    _assert_embedding_close(e.numpy(), ref_e)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(p.numpy().argmax(-1),
                                  np.asarray(ref_p).argmax(-1))


def test_embedding_mode0_random_params():
    # seed 7: seed 13's second shape has a near-tie at the 16th neighbour
    x = _shapes(512, seed=7)[..., :3]
    jmodel = JaxEmbedding(emb_size=128, num_primitives=10, mode=0, k=16)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)))
    ref_e, ref_p = jmodel.apply(jparams, jnp.asarray(x))
    flat = {k: np.array(v) for k, v in flatten_tree(dict(jparams)).items()}
    model = PrimitivesEmbedding(mode=0, k=16)
    model.load_state_dict(params_from_jax(flat, model))
    with torch.no_grad():
        e, p = model(torch.from_numpy(x))
    _assert_embedding_close(e.numpy(), ref_e)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-4,
                               atol=1e-4)
