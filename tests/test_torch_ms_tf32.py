"""K1's f32 mode and K5 in 3xTF32 (csrc/ms_iterations_tf32.cu) on the CPU:
the tf32 split, the key tiles' layout, and a plain PyTorch emulation of the
kernel's products (operands truncated to tf32 as the tensor cores read
them) held against the Pallas kernels in interpret mode. The emulation
lives here only: the port's CPU path is the plain f32 version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops.pallas_kernels import (mean_shift_iterations_pallas,
                                             mean_shift_step_pallas)
from parsenet_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _clustered(rng, n, d=128, k=8, noise=0.08):
    c = rng.randn(k, d)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.randint(0, k, n)] + noise * rng.randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _truncate(t):
    """What the tensor cores read of an f32 word: its low 13 bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a, b, products):
    """a @ b as the kernel forms it: hi.hi + hi.lo + lo.hi of the tf32
    split, each operand truncated, f32 accumulation; products=1 keeps
    hi.hi alone."""
    ah, al = (_truncate(t) for t in kernels.tf32_split(a))
    bh, bl = (_truncate(t) for t in kernels.tf32_split(b))
    out = ah @ bh
    if products == 3:
        out = out + ah @ bl + al @ bh
    return out


def _emulate(m, x, inv2b2, iterations, products=3):
    """The kernel's arithmetic: `iterations` steps of the queries m against
    the keys x with both products in 3xTF32 (or 1xTF32)."""
    for _ in range(iterations):
        k = torch.exp((2.0 * _mm(m, x.T, products) - 2.0) * inv2b2)
        new = _mm(k, x, products) / (k.sum(1, keepdim=True) + 1e-12)
        m = new / (torch.linalg.norm(new, dim=1, keepdim=True) + 1e-12)
    return m


def test_tf32_split_rounds_to_ten_mantissa_bits():
    """hi is x rounded to nearest with ties away from zero at 10 mantissa
    bits (cvt.rna.tf32.f32), bit for bit, its low 13 bits zero; hi + lo ==
    x exactly. The inputs include exact ties and values that round into the
    next binade."""
    rng = np.random.RandomState(0)
    base = rng.randn(4000).astype(np.float32)
    ties = (np.float32(1.0) + np.arange(1, 200, dtype=np.float32)
            * np.float32(2.0 ** -11))                 # halfway points
    top = np.float32(2.0) - np.float32(2.0 ** -23) * np.arange(1, 9)
    x = np.concatenate([base, ties, -ties, top, -top, [0.0]]).astype(
        np.float32)
    hi, lo = kernels.tf32_split(torch.from_numpy(x))
    mant, expo = np.frexp(np.abs(x).astype(np.float64))
    want = np.sign(x) * np.floor(mant * 2.0 ** 11 + 0.5) * 2.0 ** (expo - 11)
    np.testing.assert_array_equal(hi.numpy(), want.astype(np.float32))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal((hi + lo).numpy(), x)
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("n,d", [(37, 128), (100, 64), (16, 128), (129, 64)])
def test_ms_tiles_tf32_layout(n, d):
    """The tf32 K1's key tiles: element (R, C) of X, zero-padded to
    [ceil(N / 16) * 16, 128] and split into hi and lo, lies where the
    kernel's descriptors read it: in a tile's first half (rows x features,
    32-column blocks) and in its transposed half (a 128-byte row per
    feature, the 16 rows' hi then lo, rows in MS_TF32_SLOT_ROW order in
    each group of 8), both in the 128-byte swizzle; nothing else is
    nonzero."""
    rng = np.random.RandomState(n + d)
    x = rng.randn(n, d).astype(np.float32)
    got = kernels.ms_tiles_tf32(torch.from_numpy(x)).numpy()
    n_pad = -(-n // 16) * 16
    assert got.size == n_pad // 16 * 8192
    xp = np.zeros((n_pad, 128), np.float32)
    xp[:n, :d] = x
    hi, lo = (t.numpy() for t in kernels.tf32_split(torch.from_numpy(xp)))
    rows, cols = np.meshgrid(np.arange(n_pad), np.arange(128), indexing="ij")
    tile, r = rows // 16, rows % 16
    seen = np.zeros(got.size, bool)
    slot_of = np.array([kernels.MS_TF32_SLOT_ROW.index(i) for i in range(8)])
    for hl, part in ((0, hi), (1, lo)):
        nat = (8192 * tile + 2048 * hl + 512 * (cols // 32) + 32 * r
               + 4 * (((cols % 32) // 4) ^ (r % 8)) + cols % 4)
        s = 16 * hl + 8 * (r // 8) + slot_of[r % 8]
        trn = (8192 * tile + 4096 + 32 * cols + 4 * ((s // 4) ^ (cols % 8))
               + s % 4)
        for off in (nat, trn):
            np.testing.assert_array_equal(got[off], part)
            seen[off.ravel()] = True
    assert seen.all()


@pytest.mark.parametrize("n,bandwidth,iterations,tol", [
    (2048, 0.2, 1, 1e-5), (700, 0.1, 1, 1e-5), (1000, 0.2, 50, 1e-3)])
def test_3xtf32_emulation_matches_pallas_f32(n, bandwidth, iterations, tol):
    """The kernel's 3xTF32 arithmetic against the Pallas K1 with f32 dots
    (interpret mode): max |d| within 1e-5 after 1 iteration and 1e-3 after
    50, the limits chip_smoke holds the card's kernel to against the plain
    f32 version. hi.hi alone (1xTF32) misses 1e-5 after one iteration, so
    the limit would catch a dropped lo term."""
    rng = np.random.RandomState(n)
    x = _clustered(rng, n)
    ref = np.asarray(mean_shift_iterations_pallas(
        jnp.asarray(x), jnp.float32(bandwidth), iterations, interpret=True))
    xt = torch.from_numpy(x)
    inv2b2 = 1.0 / (2.0 * bandwidth * bandwidth)
    got = _emulate(xt, xt, inv2b2, iterations).numpy()
    assert np.abs(got - ref).max() <= tol
    if iterations == 1:
        hi_only = _emulate(xt, xt, inv2b2, 1, products=1).numpy()
        assert np.abs(hi_only - ref).max() > 1e-5


def test_3xtf32_emulation_matches_pallas_step():
    """K5: one 3xTF32 step of perturbed queries against the keys, held
    against the Pallas step (interpret mode) at m = x's shape (Nq = Nk,
    where its query-count mask and the port's key-count mask agree):
    within 1e-5; hi.hi alone misses it."""
    rng = np.random.RandomState(5)
    x = _clustered(rng, 1024)
    m = x + 0.01 * rng.randn(*x.shape).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    inv2b2 = 1.0 / (2.0 * 0.15 * 0.15)
    ref = np.asarray(mean_shift_step_pallas(
        jnp.asarray(m), jnp.asarray(x), jnp.float32(inv2b2), interpret=True))
    mt, xt = torch.from_numpy(m), torch.from_numpy(x)
    got = _emulate(mt, xt, inv2b2, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    assert np.abs(_emulate(mt, xt, inv2b2, 1, products=1).numpy()
                  - ref).max() > 1e-5


@pytest.mark.parametrize("nq,nk", [(300, 1000), (1000, 300)])
def test_ms_plan_tf32_separate_keys(nq, nk):
    """K5's plan: blocks of 128 queries against 16-row key tiles; the grid
    fills the SMs and every (row block, key tile) unit has one owner."""
    blocks, tiles = -(-nq // 128), -(-nk // 16)
    grid, slots = kernels.ms_plan(nq, 132, kernels.MS_TF32_TILE, nk)
    assert grid == min(132, blocks * tiles)
    units = blocks * tiles
    owners = [((u + 1) * grid - 1) // units for u in range(units)]
    assert sorted(set(owners)) == list(range(grid))
    assert slots == max(owners[b * tiles + tiles - 1] - owners[b * tiles] + 1
                        for b in range(blocks))
