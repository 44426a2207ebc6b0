"""Port parity: K3's plain version against the Pallas min-sqdist kernel
(interpret mode), and the reference-protocol coverage against the JAX
package with the same uniforms."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from parsenet_tpu.eval import pipeline as jp
from parsenet_tpu.ops.pallas_kernels import min_sqdist_with_idx_pallas
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.ops import kernels
from parsenet_tpu_torch.ops.chamfer import min_sqdist

torch.set_num_threads(1)


def _unique_min(q, x, margin=1e-5):
    """Queries whose second-nearest target is more than `margin` farther."""
    d = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    part = np.partition(d, 1, axis=1)
    return part[:, 1] - part[:, 0] > margin


def test_k3_plain_matches_pallas_unaligned(rng):
    q = rng.randn(300, 3).astype(np.float32)
    x = rng.randn(1500, 3).astype(np.float32)
    ref_d, ref_i = min_sqdist_with_idx_pallas(jnp.asarray(q), jnp.asarray(x),
                                              interpret=True)
    d, i = kernels.min_sqdist_with_idx_plain(torch.from_numpy(q),
                                             torch.from_numpy(x))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-6)
    uniq = _unique_min(q, x)
    assert uniq.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[uniq], np.asarray(ref_i)[uniq])


def test_k3_plain_matches_pallas_mask(rng):
    q = rng.randn(64, 3).astype(np.float32)
    x = np.concatenate([q + 100, q]).astype(np.float32)  # near copies masked
    mask = np.concatenate([np.ones(64), np.zeros(64)]).astype(np.float32)
    ref_d, ref_i = min_sqdist_with_idx_pallas(jnp.asarray(q), jnp.asarray(x),
                                              jnp.asarray(mask),
                                              interpret=True)
    d, i = kernels.min_sqdist_with_idx_plain(torch.from_numpy(q),
                                             torch.from_numpy(x),
                                             torch.from_numpy(mask))
    assert d.numpy().min() > 100
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_k3_all_masked_keeps_big_and_index_zero(rng):
    q = rng.randn(10, 3).astype(np.float32)
    x = rng.randn(20, 3).astype(np.float32)
    mask = np.zeros(20, np.float32)
    ref_d, ref_i = min_sqdist_with_idx_pallas(jnp.asarray(q), jnp.asarray(x),
                                              jnp.asarray(mask),
                                              interpret=True)
    d, i = kernels.min_sqdist_with_idx(torch.from_numpy(q),
                                       torch.from_numpy(x),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_min_sqdist_matches_brute_force(rng):
    q = rng.randn(257, 3).astype(np.float32)
    x = rng.randn(33, 3).astype(np.float32)
    ref = ((q[:, None] - x[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(
        min_sqdist(torch.from_numpy(q), torch.from_numpy(x)).numpy(), ref,
        rtol=1e-5, atol=1e-6)


def test_protocol_coverage_matches_jax(rng):
    pts = rng.rand(1024, 3).astype(np.float32) - 0.5
    surf = np.concatenate([pts[rng.randint(0, 1024, 4096)]
                           + 0.01 * rng.randn(4096, 3) for _ in range(3)]
                          + [rng.rand(4096, 3) * 4.0 + 1.0]).astype(np.float32)
    # integer area weights: their running sums are exact in f32 in any
    # summation order, so both sides draw the same samples
    w = rng.randint(0, 4, surf.shape[0]).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jp.protocol_coverage(jnp.asarray(pts), jnp.asarray(surf),
                               jnp.asarray(w), key)
    u = np.array(jax.random.uniform(jax.random.fold_in(key, 7),
                                    (jp.COV_SAMPLES,)))
    got = tp.protocol_coverage(torch.from_numpy(pts), torch.from_numpy(surf),
                               torch.from_numpy(w), torch.from_numpy(u))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)
