"""The min-sqdist pair (K3 forward, K4 backward) on the CPU: K3's plain
version against the Pallas kernel (interpret mode) on exact ties, K4's
against min_sqdist_fused's VJP where many queries share one argmin,
MinSqdist's unchecked backward path, and K3's launch plan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops.pallas_kernels import (min_sqdist_fused,
                                             min_sqdist_with_idx_pallas)
from parsenet_tpu_torch.ops import kernels

torch.set_num_threads(1)

SMS = 132  # an H100 SXM
# (B, N, M) of the main paths: protocol coverage 10k x 10k, trimming 204,800
# surface samples against 2,500 points, the SplineNet loss, and the spline
# slots' 12 x (10,000 vs 4,096) of a later slice
MAIN_SHAPES = [(1, 10000, 10000), (1, 204800, 2500), (36, 700, 1600),
               (12, 10000, 4096)]
RAGGED = (1, 63, 65, 1601)


def _grid_points(rng, n):
    """n points with integer coordinates in [-6, 6]: every squared distance,
    in any order of operations, is exact in f32."""
    return rng.randint(-6, 7, (n, 3)).astype(np.float32)


def _duplicated(rng, x):
    """Every target twice, shuffled."""
    return x[rng.permutation(np.concatenate([np.arange(len(x))] * 2))]


def _first_argmin(q, x):
    d = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    return d.min(1), d.argmin(1)   # argmin returns the first minimum


@pytest.mark.parametrize("n,m", [(1, 1), (200, 150), (300, 700)])
def test_k3_plain_matches_pallas_on_exact_ties(rng, n, m):
    """Duplicated targets on an integer grid: many queries have several
    targets at exactly their minimum, and the first index must win, in the
    Pallas kernel as in the plain version, and equal everywhere."""
    q = _grid_points(rng, n)
    x = _duplicated(rng, _grid_points(rng, m))
    ref_d, ref_i = min_sqdist_with_idx_pallas(jnp.asarray(q), jnp.asarray(x),
                                              interpret=True)
    d, i = kernels.min_sqdist_with_idx_plain(torch.from_numpy(q),
                                             torch.from_numpy(x))
    want_d, want_i = _first_argmin(q, x)
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(d.numpy(), want_d.astype(np.float32))
    np.testing.assert_array_equal(i.numpy(), want_i)


def test_k3_plain_batched_ties_and_a_fully_masked_patch(rng):
    """Batched, with ties and masks, against jax.vmap of the Pallas kernel;
    patch 1 has every target masked: 1e30 and index 0 there."""
    q = np.stack([_grid_points(rng, 90) for _ in range(3)])
    x = np.stack([_duplicated(rng, _grid_points(rng, 60)) for _ in range(3)])
    mask = (rng.rand(3, 120) < 0.7).astype(np.float32)
    mask[1] = 0.0
    ref_d, ref_i = jax.vmap(lambda a, b, k: min_sqdist_with_idx_pallas(
        a, b, k, interpret=True))(jnp.asarray(q), jnp.asarray(x),
                                  jnp.asarray(mask))
    d, i = kernels.min_sqdist_with_idx(torch.from_numpy(q),
                                       torch.from_numpy(x),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    assert (d[1] == kernels.MIN_SQDIST_BIG).all() and (i[1] == 0).all()
    for b in (0, 2):
        keep = np.flatnonzero(mask[b] > 0)
        want_d, want_i = _first_argmin(q[b], x[b][keep])
        np.testing.assert_array_equal(d[b].numpy(), want_d.astype(np.float32))
        np.testing.assert_array_equal(i[b].numpy(), keep[want_i])


def _clustered_queries(rng, b, n, m):
    """m targets far apart and n queries in tight clouds around them, so
    that every target is the argmin of about n / m queries."""
    x = (10.0 * rng.randn(b, m, 3)).astype(np.float32)
    owner = rng.randint(0, m, (b, n))
    q = (np.take_along_axis(x, owner[..., None], 1)
         + 0.05 * rng.randn(b, n, 3)).astype(np.float32)
    return q, x


@pytest.mark.parametrize("b,n,m", [(1, 500, 3), (4, 300, 7), (2, 700, 40)])
def test_k4_plain_matches_pallas_vjp_on_shared_argmins(rng, b, n, m):
    """min_sqdist_bwd_plain on the forward's argmins against jax.vjp of
    min_sqdist_fused (interpret mode), where many queries share each
    argmin: dx sums up to n / m contributions a target."""
    q, x = _clustered_queries(rng, b, n, m)
    g = rng.rand(b, n).astype(np.float32)
    ref_dq, ref_dx = [], []
    for p in range(b):
        _, vjp = jax.vjp(lambda a, c: min_sqdist_fused(a, c, None, True),
                         jnp.asarray(q[p]), jnp.asarray(x[p]))
        rq, rx = vjp(jnp.asarray(g[p]))
        ref_dq.append(np.asarray(rq))
        ref_dx.append(np.asarray(rx))
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    idx = kernels.min_sqdist_with_idx(qt, xt)[1]
    assert np.bincount(idx.numpy().ravel(), minlength=m).min() >= 2
    dq, dx = kernels.min_sqdist_bwd_plain(qt, xt, idx, torch.from_numpy(g))
    np.testing.assert_allclose(dq.numpy(), np.stack(ref_dq), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.stack(ref_dx), rtol=1e-5,
                               atol=1e-5)


def test_min_sqdist_lean_backward_equals_plain(rng):
    """MinSqdist's backward takes kernels._min_sqdist_bwd, which skips
    min_sqdist_bwd's checks; on the CPU it is the plain version, and the
    gradients MinSqdist returns are exactly its output."""
    q, x = _clustered_queries(rng, 3, 200, 9)
    g = rng.rand(3, 200).astype(np.float32)
    qt, xt, gt = (torch.from_numpy(a) for a in (q, x, g))
    idx = kernels.min_sqdist_with_idx(qt, xt)[1]
    lean = kernels._min_sqdist_bwd(qt, xt, idx, gt)
    plain = kernels.min_sqdist_bwd_plain(qt, xt, idx, gt)
    checked = kernels.min_sqdist_bwd(qt, xt, idx, gt)
    for a, b, c in zip(lean, plain, checked):
        assert torch.equal(a, b) and torch.equal(a, c)
    qg, xg = qt.clone().requires_grad_(), xt.clone().requires_grad_()
    (kernels.MinSqdist.apply(qg, xg) * gt).sum().backward()
    assert torch.equal(qg.grad, plain[0]) and torch.equal(xg.grad, plain[1])


def test_min_sqdist_autograd_takes_batches_only():
    q = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="B, N, 3"):
        kernels.MinSqdist.apply(q, q)


def _plan_cover(b, n, m, sms):
    """The (query, target) blocks of K3's grid as the kernel indexes them:
    per patch, the list of each block's query rows and target range."""
    r, threads, splits = kernels.min_sqdist_plan(b, n, m, sms)
    chunk = -(-m // splits)
    per_block = threads * r
    blocks = []
    for qb in range(-(-n // per_block)):
        rows = (qb * per_block + np.arange(r)[:, None] * threads
                + np.arange(threads)[None, :]).ravel()
        rows = rows[rows < n]
        for s in range(splits):
            blocks.append((rows, s * chunk, min(m, (s + 1) * chunk)))
    return (r, threads, splits), blocks


@pytest.mark.parametrize(
    "b,n,m", MAIN_SHAPES + [(2, n, m) for n in RAGGED for m in RAGGED])
def test_min_sqdist_plan_covers_every_pair_once(b, n, m):
    """Every (query, target) pair of a patch falls in exactly one block:
    the blocks' query rows partition [0, N) the same way for every split,
    and the splits' target ranges partition [0, M), none empty."""
    (r, threads, splits), blocks = _plan_cover(b, n, m, SMS)
    assert r in (4, 8) and threads % 32 == 0 and 32 <= threads <= 256
    assert 1 <= splits <= 65535
    rows = np.concatenate([blk[0] for blk in blocks if blk[1] == 0])
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
    ranges = sorted({(lo, hi) for _, lo, hi in blocks})
    assert len(ranges) == splits and ranges[0][0] == 0
    assert ranges[-1][1] == m and all(lo < hi for lo, hi in ranges)
    assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
    pairs = sum(len(rw) * (hi - lo) for rw, lo, hi in blocks)
    assert pairs == n * m


@pytest.mark.parametrize("b,n,m", MAIN_SHAPES)
def test_min_sqdist_plan_fills_the_card(b, n, m):
    """At each main-path shape at least 90% of the SMs get a block and each
    of them at least 8 warps; the split the plan picks costs no more, in its
    own model, than any other split up to 16 blocks an SM."""
    r, threads, splits = kernels.min_sqdist_plan(b, n, m, SMS)
    base = b * -(-n // (threads * r))
    blocks = base * splits
    busy = min(blocks, SMS)
    assert busy >= 0.9 * SMS
    assert blocks * threads // 32 >= 8 * busy

    def cost(s):
        per_sm = -(-base * s // SMS)
        return (per_sm * (-(-m // s) + kernels.MSQ_BLOCK_COST)
                / min(1.0, per_sm * threads / 32 / kernels.MSQ_SAT_WARPS))

    top = -(-m // kernels.MSQ_MIN_CHUNK)
    assert all(cost(splits) <= cost(s) + 1e-9
               for s in range(1, min(top, 16 * SMS // base) + 1))


@pytest.mark.parametrize("count,size,width", [(500, 7, 3), (2000, 300, 1),
                                              (64, 1, 5), (0, 4, 3)])
def test_ordered_scatter_sub_sums_in_query_order(rng, count, size, width):
    """K4's dx order, as its plain version computes it: out[r] = ((0 -
    v[i1]) - v[i2]) - ... over ascending i, bit for bit against a Python
    loop, with values of mixed magnitude so that another order would
    round differently; rows no value names stay 0."""
    rows = torch.from_numpy(rng.randint(0, size, count))
    vals = torch.from_numpy((rng.randn(count, width)
                             * 10.0 ** rng.randint(-4, 4, (count, 1)))
                            .astype(np.float32))
    want = torch.zeros((size, width))
    for i in range(count):
        want[rows[i]] = want[rows[i]] - vals[i]
    got = kernels.ordered_scatter_sub(rows, vals, size)
    assert torch.equal(got, want)
    if count >= 500:   # the order shows in the bits
        back = torch.zeros((size, width))
        for i in reversed(range(count)):
            back[rows[i]] = back[rows[i]] - vals[i]
        assert not torch.equal(back, want)


def test_ordered_scatter_sub_without_zero_rows_keeps_every_bit(rng):
    """K4 leaves out of its chains the queries whose dq is zero in all
    three components (the e2e loss gives 0 to the points off a slot's GT
    segment). That must change no bit of dx, the sign of a zero included:
    the sum with those rows (+0 and -0 among them, and rows whose other
    values cancel to an exact 0) against the sum without them."""
    count, size = 3000, 40
    rows = torch.from_numpy(rng.randint(0, size, count))
    vals = rng.randn(count, 3).astype(np.float32)
    zero = rng.rand(count) < 0.8
    vals[zero] = 0.0
    vals[zero & (rng.rand(count) < 0.5)] *= -1.0        # -0 rows
    vals[rows.numpy() == 0] = 0.0
    vals[:2] = [[1.5, -2.0, 0.25], [-1.5, 2.0, -0.25]]  # cancel to 0 ...
    rows[:2] = 1
    rows[2:][rows[2:] == 1] = 2                          # ... alone in row 1
    vals = torch.from_numpy(vals)
    keep = (vals != 0).any(1)
    full = kernels.ordered_scatter_sub(rows, vals, size)
    kept = kernels.ordered_scatter_sub(rows[keep], vals[keep], size)
    assert int((~keep).sum()) > count // 2
    assert torch.equal(full.view(torch.int32), kept.view(torch.int32))
    assert torch.equal(full[0].view(torch.int32),
                       torch.zeros(3).view(torch.int32))
    assert torch.equal(full[1].view(torch.int32),
                       torch.zeros(3).view(torch.int32))
