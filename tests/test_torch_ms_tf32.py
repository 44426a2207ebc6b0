"""K1's f32 mode and K5 in 3xTF32 (csrc/ms_iterations_tf32.cu) on the CPU:
the tf32 split, the key tiles' layout, and a plain PyTorch emulation of the
kernel's products (operands truncated to tf32 as the tensor cores read
them) held against the Pallas kernels in interpret mode. The emulation
lives here only: the port's CPU path is the plain f32 version."""
import re

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
    """a @ b as the kernel's update forms it: hi.hi + hi.lo + lo.hi of the
    tf32 split, each operand truncated, f32 accumulation; products=1 keeps
    hi.hi alone."""
    ah, al = (_truncate(t) for t in kernels.tf32_split(a))
    bh, bl = (_truncate(t) for t in kernels.tf32_split(b))
    out = ah @ bh
    if products == 3:
        out = out + ah @ bl + al @ bh
    return out


def _scores(m, x, products):
    """m @ x.T as the kernel's score product groups it: one accumulator
    takes hi.hi and lo.hi (the n32 product's first 16 columns and the n16
    product), another hi.lo (its last 16), and the two are added."""
    mh, ml = (_truncate(t) for t in kernels.tf32_split(m))
    xh, xl = (_truncate(t) for t in kernels.tf32_split(x))
    if products == 1:
        return mh @ xh.T
    return (mh @ xh.T + ml @ xh.T) + mh @ xl.T


def _emulate(m, x, inv2b2, iterations, products=3):
    """The kernel's arithmetic: `iterations` steps of the queries m against
    the keys x with both products in 3xTF32 (or 1xTF32)."""
    for _ in range(iterations):
        k = torch.exp((2.0 * _scores(m, x, products) - 2.0) * inv2b2)
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
    32-column blocks of 32 rows, the tile's 16 rows' hi then their lo) and
    in its transposed half (a 128-byte row per feature, the 16 rows' hi
    then lo, rows in MS_TF32_SLOT_ROW order in each group of 8), both in
    the 128-byte swizzle; nothing else is nonzero."""
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
        nat = (8192 * tile + 1024 * (cols // 32) + 512 * hl + 32 * r
               + 4 * (((cols % 32) // 4) ^ (r % 8)) + cols % 4)
        s = 16 * hl + 8 * (r // 8) + slot_of[r % 8]
        trn = (8192 * tile + 4096 + 32 * cols + 4 * ((s // 4) ^ (cols % 8))
               + s % 4)
        for off in (nat, trn):
            np.testing.assert_array_equal(got[off], part)
            seen[off.ravel()] = True
    assert seen.all()


def _operand(tiles, t, kb, rows):
    """The K-major operand that a wgmma descriptor at 32-column block kb of
    tile t's first half reads: `rows` rows of 32 f32 (128 bytes each), the
    128-byte swizzle undone."""
    flat = tiles[8192 * t + 1024 * kb:][:32 * rows].reshape(rows, 8, 4)
    chunk = np.arange(8)[None, :] ^ (np.arange(rows)[:, None] % 8)
    return flat[np.arange(rows)[:, None], chunk].reshape(rows, 32)


@pytest.mark.parametrize("n", [16, 37])
def test_score_product_columns_hold_hi_hi_and_hi_lo(n):
    """The score product's operands as its descriptors read them from the
    key tiles: m hi against a block's 32 rows (one m64n32k8 a k-step) puts
    hi.hi of key c in column c and hi.lo in column 16 + c, and m lo against
    the first 16 rows (the m64n16k8) gives lo.hi; the kernel's sum of the
    two accumulators' columns c and 16 + c is _scores' grouping (here in
    f64), for every key of every tile."""
    rng = np.random.RandomState(n)
    x = _clustered(rng, n)
    m = _clustered(rng, 64)
    tiles = kernels.ms_tiles_tf32(torch.from_numpy(x)).numpy()
    mh, ml = (_truncate(t).numpy().astype(np.float64)
              for t in kernels.tf32_split(torch.from_numpy(m)))
    xh, xl = (_truncate(t).numpy().astype(np.float64)
              for t in kernels.tf32_split(torch.from_numpy(x)))
    n_tiles = -(-n // 16)
    for t in range(n_tiles):
        keys = np.arange(16 * t, min(16 * t + 16, n))
        b32 = np.concatenate([_operand(tiles, t, kb, 32)
                              for kb in range(4)], axis=1)     # [32, 128]
        b16 = np.concatenate([_operand(tiles, t, kb, 16)
                              for kb in range(4)], axis=1)
        np.testing.assert_array_equal(b16, b32[:16])
        n32 = mh @ _truncate(torch.from_numpy(b32)).numpy().T  # [64, 32]
        c = keys - 16 * t
        np.testing.assert_array_equal(n32[:, c], mh @ xh[keys].T)
        np.testing.assert_array_equal(n32[:, 16 + c], mh @ xl[keys].T)
        n16 = ml @ _truncate(torch.from_numpy(b16)).numpy().T
        np.testing.assert_array_equal(n16[:, c], ml @ xh[keys].T)
        got = (n32[:, c] + n16[:, c]) + n32[:, 16 + c]
        want = (mh @ xh[keys].T + ml @ xh[keys].T) + mh @ xl[keys].T
        np.testing.assert_array_equal(got, want)
        # the padding rows of the last tile give 0 in both halves
        pad = np.arange(len(keys), 16)
        assert not n32[:, pad].any() and not n32[:, 16 + pad].any()


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


def _wgmma_bytes_fma(kind, n):
    """Operand bytes read from shared memory and FMA of one tf32
    m64n{n}k8: A (64 x 8) from shared memory for "ss" only, B (8 x n)
    always."""
    return (64 * 8 * 4 if kind == "ss" else 0) + 8 * n * 4, 64 * n * 8


@pytest.mark.parametrize("layout,per_kstep", [
    ("ss3", [("ss", 16)] * 3), ("n32", [("ss", 32), ("ss", 16)]),
    ("rs_hi", [("rs", 32), ("ss", 16)]), ("rs", [("rs", 32), ("rs", 16)])])
def test_operand_probe_modes(layout, per_kstep):
    """kernels.MS_TF32_PROBE: each score layout's bytes and FMA a tile are
    its wgmma shapes' over 16 k-steps, the update's its 6 RS m64n128k8, and
    the modes are in the order of ms_tf32_operand_probe's switch."""
    score = [sum(x) for x in zip(*(_wgmma_bytes_fma(*w) for w in per_kstep))]
    update = [6 * x for x in _wgmma_bytes_fma("rs", 128)]
    probe = kernels.MS_TF32_PROBE
    assert probe[f"score_{layout}"] == (16 * score[0], 16 * score[1])
    assert probe["update"] == tuple(update)
    assert probe[f"score_{layout}+update"] == (16 * score[0] + update[0],
                                               16 * score[1] + update[1])
    src = (kernels.CSRC / "ms_iterations_tf32.cu").read_text()
    cases = re.findall(r"case (\d+): return probe_launch<PROBE_(\w+), (\w+)>",
                       src[src.index('int ms_tf32_operand_probe('):])
    assert [int(c) for c, _, _ in cases] == list(range(len(probe)))
    assert [("update" if name == "NONE" else f"score_{name.lower()}"
             + ("+update" if up == "true" else "")) for _, name, up in cases
            ] == list(probe)
