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
    # tol > 0: the plain early exit over the CUDA kernels' 128-row blocks
    got = kernels.mean_shift_iterations(x, 0.4, 3, tol=1e-6)
    ref = kernels.mean_shift_iterations_plain(x, 0.4, 3, tol=1e-6,
                                              exit_rows=kernels.MS_BLOCK_ROWS)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert kernels.LAUNCHES == before


def test_k1_plain_matches_pallas_bf16_ragged(rng):
    """N = 200 (not a multiple of 64 or 128) and D = 40 < 128: the shapes
    the tensor-core kernel pads and masks; the tolerance of the test
    above."""
    x = _clustered(rng, 4, 50, d=40)
    ref = mean_shift_iterations_pallas(jnp.asarray(x), jnp.float32(0.3), 10,
                                       interpret=True, bf16_dots=True)
    got = kernels.mean_shift_iterations_plain(torch.from_numpy(x), 0.3, 10,
                                              bf16_dots=True)
    assert got.shape == (200, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2)


def test_k1_bf16_wrapper_on_cpu_is_plain(rng):
    x = torch.from_numpy(_unit_rows(rng, 100, 24))
    before = dict(kernels.LAUNCHES)
    got = kernels.mean_shift_iterations(x, 0.4, 3, bf16_dots=True)
    ref = kernels.mean_shift_iterations_plain(x, 0.4, 3, bf16_dots=True)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_zero_iterations_return_x(rng, bf16):
    """No iteration gives X back in both modes; on the card the wrapper
    returns a copy before it picks a kernel (chip_smoke phase 3)."""
    x = torch.from_numpy(_unit_rows(rng, 70, 24))
    got = kernels.mean_shift_iterations(x, 0.4, 0, bf16_dots=bf16)
    np.testing.assert_array_equal(got.numpy(), x.numpy())


@pytest.mark.parametrize("bandwidth", [0.3, 0.1])
def test_sdpa_yardstick_matches_plain_f32(rng, bandwidth):
    """chip_smoke's library yardstick for K1 (scaled_dot_product_attention,
    then normalize) computes the plain version's function: the softmax's
    max shift cancels exp(-2 inv2b2). f32 on the CPU, within 1e-5."""
    import chip_smoke
    x = torch.from_numpy(_unit_rows(rng, 300, 128))
    np.testing.assert_allclose(
        chip_smoke.sdpa_mean_shift(x, bandwidth, 4).numpy(),
        kernels.mean_shift_iterations_plain(x, bandwidth, 4).numpy(),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,d", [(300, 128), (129, 40), (64, 128)])
def test_ms_tiles_bf16_layout(rng, n, d):
    """The tensor-core K1's operand: element (R, C) of bf16(X), zero-padded
    to [ceil(N / 128) * 128, 128], lies where the kernel's descriptors and
    tile_offset() read it (64-row tiles of two 64-column halves, 16-byte
    chunks swizzled by the row mod 8); every other element is 0."""
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    got = kernels.ms_tiles_bf16(x).view(torch.int16).numpy()
    want = torch.nn.functional.pad(x, (0, 128 - d)).to(
        torch.bfloat16).view(torch.int16).numpy()
    n_pad = -(-n // 128) * 128
    assert got.size == n_pad * 128
    r, c = np.meshgrid(np.arange(n), np.arange(128), indexing="ij")
    off = (8192 * (r // 64) + 4096 * (c // 64) + 64 * (r % 64)
           + 8 * (((c % 64) // 8) ^ (r % 8)) + c % 8)
    np.testing.assert_array_equal(got[off], want)
    rest = np.ones(got.size, bool)
    rest[off.ravel()] = False
    assert not got[rest].any()


@pytest.mark.parametrize("tile", [64, 16])
@pytest.mark.parametrize("n,sms", [(10000, 132), (4999, 132), (100, 132),
                                   (1, 132), (192, 132), (16640, 132),
                                   (16896, 132), (20000, 132), (10000, 7)])
def test_ms_plan_covers_every_unit(n, sms, tile):
    """Both tensor-core K1s' work split (64-row key tiles for bf16,
    MS_TF32_TILE = 16 for tf32), with the ranges the kernels compute
    (unit_start / unit_owner in ms_iterations_tc.cu and
    ms_iterations_tf32.cu): each grid block takes a contiguous, non-empty
    run of (row block, key tile) units within at most two row blocks; the
    runs cover every unit once; no row block is shared by more blocks than
    the workspace has slots; with at least as many row blocks as SMs there
    is one block per row block and no exchange."""
    blocks, tiles = -(-n // 128), -(-n // tile)
    units = blocks * tiles
    grid, slots = kernels.ms_plan(n, sms, tile)
    if blocks >= sms:
        assert (grid, slots) == (blocks, 1)
    else:
        assert grid == min(sms, units)
    starts = [g * units // grid for g in range(grid + 1)]
    assert starts[0] == 0 and starts[-1] == units
    sharers = [set() for _ in range(blocks)]
    for g in range(grid):
        u0, u1 = starts[g], starts[g + 1]
        assert u0 < u1
        rows = {u // tiles for u in range(u0, u1)}
        assert len(rows) <= 2
        for b in rows:
            sharers[b].add(g)
    assert max(len(s) for s in sharers) == slots
    assert all(sorted(s) == list(range(min(s), max(s) + 1))
               for s in sharers)


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


# ---------------------------------------------------------------------------
# K5: one mean-shift step, queries apart from keys (a mode of K1's kernel)
# ---------------------------------------------------------------------------

def test_k5_plain_matches_pallas_step(rng):
    """At m = x (Nq = Nk), the Pallas kernel's only use, where its column
    mask by the query count and the port's by the key count agree: rtol
    2e-4, atol 2e-5, as tests/test_pallas.py holds the kernel."""
    from parsenet_tpu.ops.pallas_kernels import mean_shift_step_pallas
    x = _unit_rows(rng, 300, 8)
    inv2b2 = 1.0 / (2 * 0.3 * 0.3)
    ref = mean_shift_step_pallas(jnp.asarray(x), jnp.asarray(x),
                                 jnp.float32(inv2b2), interpret=True)
    got = kernels.mean_shift_step(torch.from_numpy(x), torch.from_numpy(x),
                                  inv2b2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("nq,nk", [(200, 340), (340, 200)])
def test_k5_masks_keys_by_key_count(rng, nq, nk):
    """With Nq != Nk every one of the Nk keys counts and nothing else: the
    dense float64 formula, 1e-5."""
    m = _unit_rows(rng, nq, 16)
    x = _unit_rows(rng, nk, 16)
    inv2b2 = 1.0 / (2 * 0.4 * 0.4)
    k = np.exp((2.0 * m.astype(np.float64) @ x.T - 2.0) * inv2b2)
    new = (k @ x) / (k.sum(1, keepdims=True) + 1e-12)
    new /= np.linalg.norm(new, axis=1, keepdims=True) + 1e-12
    got = kernels.mean_shift_step(torch.from_numpy(m), torch.from_numpy(x),
                                  inv2b2)
    assert got.shape == (nq, 16)
    np.testing.assert_allclose(got.numpy(), new, rtol=1e-5, atol=1e-5)


def test_k5_step_is_one_k1_iteration(rng):
    x = torch.from_numpy(_unit_rows(rng, 128, 32))
    bw = 0.35
    np.testing.assert_allclose(
        kernels.mean_shift_step(x, x, 1.0 / (2 * bw * bw)).numpy(),
        kernels.mean_shift_iterations(x, bw, 1).numpy(), rtol=1e-6,
        atol=1e-6)
