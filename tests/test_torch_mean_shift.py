"""Port parity: K1's plain version against the Pallas kernel (interpret
mode), and the inference guard_mean_shift against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops import mean_shift as jms
from parsenet_tpu.ops.pallas_kernels import mean_shift_iterations_pallas
from parsenet_tpu_torch.ops import kernels
from parsenet_tpu_torch.ops import mean_shift as tms

torch.set_num_threads(1)


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n_clusters, per, d=128, noise=0.05):
    c = _unit_rows(rng, n_clusters, d)
    x = np.repeat(c, per, axis=0) + noise * rng.randn(n_clusters * per, d)
    x = x.astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def canonical(labels):
    """Cluster ids renumbered by first appearance (same partition iff
    equal): the point that names a converged mode rides on last-bit
    differences of the shifted embedding."""
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    rename = {int(labels[f]): r for r, f in enumerate(np.sort(first))}
    return np.array([rename[int(v)] for v in labels])


@pytest.mark.parametrize("n", [300, 512])
def test_k1_plain_matches_pallas_f32(rng, n):
    x = _unit_rows(rng, n, 128)
    ref = mean_shift_iterations_pallas(jnp.asarray(x), jnp.float32(0.5), 4,
                                       interpret=True)
    got = kernels.mean_shift_iterations_plain(torch.from_numpy(x), 0.5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4,
                               atol=5e-5)


def test_k1_plain_matches_pallas_bf16(rng):
    x = _clustered(rng, 4, 60, d=128)
    ref = mean_shift_iterations_pallas(jnp.asarray(x), jnp.float32(0.3), 10,
                                       interpret=True, bf16_dots=True)
    got = kernels.mean_shift_iterations_plain(torch.from_numpy(x), 0.3, 10,
                                              bf16_dots=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2)


def test_k1_wrapper_on_cpu_is_plain(rng):
    x = torch.from_numpy(_unit_rows(rng, 64, 16))
    before = dict(kernels.LAUNCHES)
    got = kernels.mean_shift_iterations(x, torch.tensor(0.4), 3)
    ref = kernels.mean_shift_iterations_plain(x, 0.4, 3)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="tol"):
        kernels.mean_shift_iterations(x, 0.4, 3, tol=1e-6)


@pytest.mark.parametrize("max_clusters", [49, 3])
def test_guard_mean_shift_matches_jax(rng, max_clusters):
    """Clustered embeddings; max_clusters=3 below the 6 modes forces the
    bandwidth escalation loop."""
    x = _clustered(rng, 6, 80, noise=0.08)
    n, s = x.shape[0], 256
    key = jax.random.PRNGKey(5)
    ref = jms.guard_mean_shift(jnp.asarray(x), 0.015, key=key,
                               num_samples=s, iterations=20,
                               max_clusters=max_clusters,
                               differentiable=False)
    subset = torch.from_numpy(np.array(jax.random.permutation(key, n)[:s]))
    got = tms.guard_mean_shift(torch.from_numpy(x), 0.015, num_samples=s,
                               iterations=20, max_clusters=max_clusters,
                               subset=subset)
    assert got.num_clusters == int(ref.num_clusters)
    np.testing.assert_allclose(float(got.bandwidth), float(ref.bandwidth),
                               rtol=1e-5)
    np.testing.assert_array_equal(canonical(got.labels), canonical(ref.labels))
    np.testing.assert_array_equal(got.center_mask.sum().item(),
                                  float(np.asarray(ref.center_mask).sum()))


def test_bandwidth_statistics_match_jax(rng):
    x = _unit_rows(rng, 400, 32)
    d = jms._subset_sqdist(jnp.asarray(x), None, 400)
    dt = tms._subset_sqdist(torch.from_numpy(x), 400)
    np.testing.assert_allclose(dt.numpy(), np.asarray(d), atol=1e-6)
    np.testing.assert_allclose(
        float(tms._initial_bandwidth(dt, 0.015)),
        float(jms._initial_bandwidth(d, 0.015)), rtol=1e-6)
    for q in (0.03, 0.12):
        np.testing.assert_allclose(
            float(tms._escalation_bandwidth(dt, np.float32(q))),
            float(jms._escalation_bandwidth(d, jnp.float32(q))), rtol=1e-6)
