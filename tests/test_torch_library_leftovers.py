"""Port parity: the library functions this slice adds, against the JAX
package on the same numpy inputs (the JAX package's draws handed over):

* ops/mean_shift.mean_shift (no NMS; parsenet_tpu/ops/mean_shift.py:308):
  shifted within 1e-5 and the bandwidth within 1e-6 relative, and
  jax.grad of sum(shifted) against the port's autograd within 1e-4
  relative (grad on: mean_shift_iterations_autograd; off: K1 f32's plain
  version here, the same numbers);
* the Epanechnikov kernel: its iterations within 1e-5, its gradient, and
  guard_mean_shift(kernel="epanechnikov") in both forms, the same
  clustering;
* ops/segmentation.match: the same permutation as the JAX package's;
* ops/sampling.sample_torus, project_to_plane, project_to_point_cloud:
  within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops import mean_shift as jm
from parsenet_tpu.ops import sampling as js
from parsenet_tpu.ops import segmentation as jseg
from parsenet_tpu_torch.ops import mean_shift as tm
from parsenet_tpu_torch.ops import sampling as ts
from parsenet_tpu_torch.ops import segmentation as tseg

torch.set_num_threads(1)


def _embedding(seed, n=96, d=8, k=4):
    rng = np.random.RandomState(seed)
    c = rng.randn(k, d)
    x = c[rng.randint(k, size=n)] + 0.15 * rng.randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def canonical(labels):
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    rename = {int(labels[f]): r for r, f in enumerate(np.sort(first))}
    return np.array([rename[int(v)] for v in labels])


@pytest.mark.parametrize("kernel", ["gaussian", "epanechnikov"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mean_shift_and_its_gradient_match_jax(kernel, seed):
    x = _embedding(seed)
    key = jax.random.PRNGKey(seed)
    s = 64
    quantile = 0.2 if kernel == "gaussian" else 0.4
    shifted, bw = jm.mean_shift(jnp.asarray(x), quantile, key, num_samples=s,
                                iterations=5, kernel=kernel)
    subset = torch.from_numpy(np.asarray(
        jax.random.permutation(key, len(x))[:s]))
    with torch.no_grad():
        t_shift, t_bw = tm.mean_shift(torch.from_numpy(x), quantile,
                                      num_samples=s, iterations=5,
                                      kernel=kernel, subset=subset)
    np.testing.assert_allclose(float(t_bw), float(bw), rtol=1e-6)
    np.testing.assert_allclose(t_shift.numpy(), np.asarray(shifted),
                               rtol=1e-5, atol=1e-5)
    g = jax.grad(lambda xx: jnp.sum(jm.mean_shift(
        xx, quantile, key, num_samples=s, iterations=5,
        kernel=kernel)[0]))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tm.mean_shift(tx, quantile, num_samples=s, iterations=5,
                           kernel=kernel, subset=subset)
    torch.sum(out).backward()
    g = np.asarray(g)
    np.testing.assert_allclose(tx.grad.numpy(), g, rtol=1e-4,
                               atol=1e-4 * np.abs(g).max())


def test_epanechnikov_iterations_match_jax():
    x = _embedding(3, n=128)
    for it in (1, 10):
        want = jm.mean_shift_iterations(jnp.asarray(x), jnp.float32(0.5),
                                        it, kernel="epanechnikov")
        got = tm.mean_shift_iterations_epanechnikov(
            torch.from_numpy(x), torch.tensor(0.5), it)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("differentiable", [False, True])
def test_guard_with_epanechnikov_matches_jax(differentiable):
    x = _embedding(4, n=120, k=5)
    key = jax.random.PRNGKey(4)
    s = 64
    want = jm.guard_mean_shift(jnp.asarray(x), 0.1, key, num_samples=s,
                               iterations=8, kernel="epanechnikov",
                               differentiable=differentiable)
    subset = torch.from_numpy(np.asarray(
        jax.random.permutation(key, len(x))[:s]))
    got = tm.guard_mean_shift(torch.from_numpy(x), 0.1, num_samples=s,
                              iterations=8, subset=subset,
                              kernel="epanechnikov",
                              differentiable=differentiable)
    np.testing.assert_allclose(float(got.bandwidth), float(want.bandwidth),
                               rtol=1e-6)
    assert got.num_clusters == int(want.num_clusters)
    np.testing.assert_array_equal(canonical(got.labels.numpy()),
                                  canonical(np.asarray(want.labels)))
    np.testing.assert_allclose(got.shifted.detach().numpy(),
                               np.asarray(want.shifted), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tm.guard_mean_shift(torch.from_numpy(x), 0.1, kernel="epanechnikov",
                            bf16_dots=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_gives_the_jax_permutation(seed):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 7, size=300)
    pred = (gt + rng.randint(0, 2, size=300) * rng.randint(0, 9, size=300)
            ) % 9
    want = np.asarray(jseg.match(jnp.asarray(gt), jnp.asarray(pred)))
    got = tseg.match(torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(jseg.K_MAX))
    batched = tseg.match(torch.from_numpy(np.stack([gt, gt])),
                         torch.from_numpy(np.stack([pred, pred]))).numpy()
    np.testing.assert_array_equal(batched, np.stack([want, want]))


def test_sampling_functions_match_jax():
    rng = np.random.RandomState(6)
    axis = rng.randn(3, 3).astype(np.float32)
    axis[2] = [1.0, 0.0, 0.0]       # the frame's other branch
    center = rng.randn(3, 3).astype(np.float32)
    major = (1.0 + rng.rand(3)).astype(np.float32)
    minor = (0.1 + 0.3 * rng.rand(3)).astype(np.float32)
    got = ts.sample_torus(*map(torch.from_numpy, (axis, center, major,
                                                   minor)), 12).numpy()
    for i in range(3):
        want = js.sample_torus(jnp.asarray(axis[i]), jnp.asarray(center[i]),
                               major[i], minor[i], 12)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    pts = rng.randn(200, 3).astype(np.float32)
    np.testing.assert_allclose(
        ts.project_to_plane(torch.from_numpy(pts), torch.from_numpy(axis[0]),
                            0.25).numpy(),
        np.asarray(js.project_to_plane(jnp.asarray(pts),
                                       jnp.asarray(axis[0]), 0.25)),
        rtol=1e-6, atol=1e-6)
    surf = rng.randn(150, 3).astype(np.float32)
    np.testing.assert_allclose(
        ts.project_to_point_cloud(torch.from_numpy(pts),
                                  torch.from_numpy(surf)).numpy(),
        np.asarray(js.project_to_point_cloud(jnp.asarray(pts),
                                             jnp.asarray(surf))),
        rtol=1e-6, atol=1e-6)
