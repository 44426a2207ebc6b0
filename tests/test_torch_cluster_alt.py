"""Port parity: ops/cluster_alt.py against parsenet_tpu/ops/cluster_alt.py
on the same numpy inputs, with the JAX package's random draws (the first
centre from jax.random.randint, spectral clustering's V0 from
jax.random.normal and its KMeans's first centre from the folded key)
handed to the port. KMeans labels equal and centres within 1e-5;
spectral labels equal up to renumbering on blobs; the membership
functions within 1e-6 relative; `cluster` dispatches as the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops import cluster_alt as jc
from parsenet_tpu_torch.ops import cluster_alt as tc

torch.set_num_threads(1)


def _blobs(seed, k=4, per=30, d=5, spread=0.08):
    rng = np.random.RandomState(seed)
    centres = rng.randn(k, d) * 1.5
    x = np.concatenate([c + spread * rng.randn(per, d) for c in centres])
    return x[rng.permutation(len(x))].astype(np.float32)


def _first(key, n):
    return int(jax.random.randint(key, (), 0, n))


def canonical(labels):
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    rename = {int(labels[f]): r for r, f in enumerate(np.sort(first))}
    return np.array([rename[int(v)] for v in labels])


@pytest.mark.parametrize("seed, k", [(0, 4), (1, 3), (2, 6)])
def test_kmeans_matches_jax(seed, k):
    x = _blobs(seed)
    key = jax.random.PRNGKey(seed + 10)
    jl, jcen = jc.kmeans(jnp.asarray(x), k, key)
    tl, tcen = tc.kmeans(torch.from_numpy(x), k, _first(key, len(x)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tcen.numpy(), np.asarray(jcen), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_more_clusters_than_distinct_points():
    x = np.repeat(_blobs(3, k=2, per=2), 3, axis=0)
    key = jax.random.PRNGKey(0)
    jl, jcen = jc.kmeans(jnp.asarray(x), 6, key)
    tl, tcen = tc.kmeans(torch.from_numpy(x), 6, _first(key, len(x)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert np.isfinite(tcen.numpy()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_spectral_matches_jax_on_blobs(seed):
    x = _blobs(seed, k=3, per=25, d=3, spread=0.05)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jc.spectral_cluster(jnp.asarray(x), 3, key))
    v0 = np.asarray(jax.random.normal(key, (len(x), 3)))
    first = _first(jax.random.fold_in(key, 1), len(x))
    got = tc.spectral_cluster(torch.from_numpy(x), 3, torch.from_numpy(v0),
                              first).numpy()
    np.testing.assert_array_equal(canonical(got), canonical(want))
    assert len(np.unique(got)) == 3


def test_cluster_dispatch_matches_jax():
    x = _blobs(4, k=3, per=40, d=8, spread=0.05)
    key = jax.random.PRNGKey(7)
    n = len(x)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tc.cluster(t, 3, "kmeans", first=_first(key, n)).numpy(),
        np.asarray(jc.cluster(jnp.asarray(x), 3, "kmeans", key)))
    np.testing.assert_array_equal(
        canonical(tc.cluster(t, 3, "spectral", first=_first(
            jax.random.fold_in(key, 1), n), v0=torch.from_numpy(np.asarray(
                jax.random.normal(key, (n, 3))))).numpy()),
        canonical(np.asarray(jc.cluster(jnp.asarray(x), 3, "spectral",
                                        key))))
    # mean-shift: the JAX guard's bandwidth subset is permutation(key)[:S]
    # with S = min(5000, N) = N, so the first N rows either way
    want = np.asarray(jc.cluster(jnp.asarray(x), 3, "meanshift", key))
    got = tc.cluster(t, 3, "meanshift").numpy()
    np.testing.assert_array_equal(canonical(got), canonical(want))
    with pytest.raises(ValueError):
        tc.cluster(t, 3, "dbscan")
    # draws not given come from the generator
    g = torch.Generator().manual_seed(0)
    assert tc.cluster(t, 3, "kmeans", generator=g).shape == (n,)


@pytest.mark.parametrize("normalize", [False, True])
def test_membership_functions_match_jax(normalize):
    rng = np.random.RandomState(5)
    e = rng.randn(50, 8).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    c = e[[0, 10, 20]] + 0.01
    te, tcen = torch.from_numpy(e), torch.from_numpy(c)
    np.testing.assert_allclose(
        tc.cluster_prob_softmax(te, tcen).numpy(),
        np.asarray(jc.cluster_prob_softmax(e, c)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tc.cluster_prob_gaussian(te, tcen, 0.3).numpy(),
        np.asarray(jc.cluster_prob_gaussian(e, c, 0.3)), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        tc.cluster_prob_mutual(te, tcen, 0.5, normalize).numpy(),
        np.asarray(jc.cluster_prob_mutual(e, c, 0.5, normalize)), rtol=1e-6,
        atol=1e-7)
