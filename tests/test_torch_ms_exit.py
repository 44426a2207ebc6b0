"""Port parity: K1's early exit (tol > 0), the plain version against the
Pallas kernel in interpret mode (its early_exit=True variant), and the
inference guard_mean_shift with tol against the JAX package's with
pallas_tol. The CUDA exit kernels are held to the plain version on the
card (chip_smoke.py phase 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops import mean_shift as jms
from parsenet_tpu.ops.pallas_kernels import (ROW_TILE,
                                             mean_shift_iterations_pallas)
from parsenet_tpu_torch.ops import kernels
from parsenet_tpu_torch.ops import mean_shift as tms

torch.set_num_threads(1)

TOL = 1e-6


def _clustered(rng, n_clusters, per, d=128, noise=0.05):
    c = rng.randn(n_clusters, d)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = np.repeat(c, per, axis=0) + noise * rng.randn(n_clusters * per, d)
    x = x[rng.permutation(len(x))].astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def canonical(labels):
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    rename = {int(labels[f]): r for r, f in enumerate(np.sort(first))}
    return np.array([rename[int(v)] for v in labels])


@pytest.mark.parametrize("n,bf16", [(512, False), (700, False), (768, False),
                                    (1024, False), (512, True), (768, True),
                                    (1000, True)])
def test_exit_plain_matches_pallas(rng, n, bf16):
    """The plain version at exit_rows = ROW_TILE (256) against the TPU
    kernel's early exit in interpret mode: 1e-5 in f32, 2e-2 in bf16 (the
    tolerance of the fixed-count bf16 comparison, tests/test_pallas.py); in
    f32 some tiles stop early. At N = 700 and 1,000 the TPU kernel's last
    tile holds padding rows, which its delta counts and the port's does
    not."""
    x = _clustered(rng, 6, n // 6 + 1)[:n]
    ref = mean_shift_iterations_pallas(jnp.asarray(x), jnp.float32(0.25), 40,
                                       interpret=True, bf16_dots=bf16,
                                       tol=TOL)
    got = kernels.mean_shift_iterations_plain(torch.from_numpy(x), 0.25, 40,
                                              bf16_dots=bf16, tol=TOL,
                                              exit_rows=ROW_TILE)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2 if bf16 else 1e-5)
    counts = kernels.mean_shift_exit_counts(torch.from_numpy(x), 0.25, 40,
                                            bf16_dots=bf16, tol=TOL,
                                            exit_rows=ROW_TILE)
    assert counts.shape == (-(-n // ROW_TILE),)
    print(f"iterations per 256-row tile: {counts.tolist()}")
    if not bf16:   # bf16 products can keep a tile moving by more than tol
        assert int(counts.min()) < 40, counts


@pytest.mark.parametrize("bf16", [False, True])
def test_exit_at_block_rows_matches_full_run(rng, bf16):
    """exit_rows = 128, the CUDA kernels' group, against the fixed-count run
    within 1e-4 (as tests/test_pallas.py holds the TPU kernel's exit)."""
    x = torch.from_numpy(_clustered(rng, 3, 150))
    full = kernels.mean_shift_iterations_plain(x, 0.25, 30, bf16_dots=bf16)
    early = kernels.mean_shift_iterations_plain(
        x, 0.25, 30, bf16_dots=bf16, tol=TOL,
        exit_rows=kernels.MS_BLOCK_ROWS)
    np.testing.assert_allclose(early.numpy(), full.numpy(), rtol=0,
                               atol=1e-4)
    counts = kernels.mean_shift_exit_counts(
        x, 0.25, 30, bf16_dots=bf16, tol=TOL, exit_rows=kernels.MS_BLOCK_ROWS)
    assert counts.shape == (4,) and int(counts.max()) < 30, counts


def test_exit_counts(rng):
    """Iterations run per group: all at tol = 0, fewer once the groups
    converge, and a group that stops keeps its m."""
    x = torch.from_numpy(_clustered(rng, 4, 100, d=32))
    full = kernels.mean_shift_exit_counts(x, 0.3, 25)
    assert full.tolist() == [25] * 4
    counts = kernels.mean_shift_exit_counts(x, 0.3, 25, tol=1e-5,
                                            exit_rows=100)
    assert (counts < 25).all() and (counts >= 1).all(), counts
    i = int(torch.argmin(counts))
    stop = kernels.mean_shift_iterations_plain(x, 0.3, int(counts[i]),
                                               tol=1e-5, exit_rows=100)
    more = kernels.mean_shift_iterations_plain(x, 0.3, 25, tol=1e-5,
                                               exit_rows=100)
    rows = slice(100 * i, 100 * (i + 1))
    np.testing.assert_array_equal(stop[rows].numpy(), more[rows].numpy())


@pytest.mark.parametrize("bf16", [False, True])
def test_guard_mean_shift_tol_matches_jax(rng, bf16):
    """The inference guard with tol against the JAX guard with
    pallas_tol (interpret mode): the same clusters and bandwidth. The port
    on the CPU stops 128-row blocks, the TPU kernel 256-row tiles; both
    stop within tol of the fixed points."""
    x = _clustered(rng, 5, 103, noise=0.08)
    n, s = x.shape[0], 256
    key = jax.random.PRNGKey(9)
    ref = jms.guard_mean_shift(jnp.asarray(x), 0.015, key=key,
                               num_samples=s, iterations=30,
                               use_pallas=True, pallas_bf16=bf16,
                               pallas_tol=TOL, pallas_interpret=True,
                               differentiable=False)
    subset = torch.from_numpy(np.array(jax.random.permutation(key, n)[:s]))
    got = tms.guard_mean_shift(torch.from_numpy(x), 0.015, num_samples=s,
                               iterations=30, bf16_dots=bf16, subset=subset,
                               tol=TOL)
    assert got.num_clusters == int(ref.num_clusters)
    np.testing.assert_allclose(float(got.bandwidth), float(ref.bandwidth),
                               rtol=1e-5)
    np.testing.assert_array_equal(canonical(got.labels),
                                  canonical(ref.labels))
    np.testing.assert_allclose(got.shifted.numpy(), np.asarray(ref.shifted),
                               rtol=0, atol=2e-2 if bf16 else 1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_deltas_give_the_counts(bf16):
    """The plain version's per-group deltas (what chip_smoke.py compares
    the kernels' decisions with): each group's count is the first iteration
    whose delta is <= tol, all of them if none, and its deltas are NaN
    after it leaves."""
    x = torch.from_numpy(_clustered(np.random.RandomState(5), 7, 100, d=64))
    tol = 1e-4
    _, counts, deltas = kernels._ms_plain(x, 0.25, 20, bf16, tol, 128)
    assert deltas.shape[1] == counts.shape[0] == 6
    for g in range(6):
        d = deltas[:, g]
        live = ~torch.isnan(d)
        assert int(live.sum()) == int(counts[g])
        below = torch.nonzero(d[live] <= tol).flatten()
        want = int(below[0]) + 1 if below.numel() else 20
        assert int(counts[g]) == want
