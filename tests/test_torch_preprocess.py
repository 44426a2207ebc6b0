"""Port parity: the spline slots' preprocessing against the JAX package.

ops.standardize (the minor-axis rotation, with its sign as the Jacobi
eigh gives it), ops.preprocess (packing, statistical outliers, repacking,
NN-centroid upsampling, the fixed draw, and eval_segment_points end to
end) and the batched kNN, on the CPU, with the JAX package's own random
draws handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops import knn as jknn
from parsenet_tpu.ops import preprocess as jpp
from parsenet_tpu.ops import standardize as jst
from parsenet_tpu_torch.ops import knn as tknn
from parsenet_tpu_torch.ops import preprocess as tpp
from parsenet_tpu_torch.ops import standardize as tst

torch.set_num_threads(1)

N, S = 2048, 3


def _segment(rng, n, scale=(1.0, 0.6, 0.03)):
    """A noisy curved patch of n points, rotated and moved at random."""
    u, v = rng.rand(n), rng.rand(n)
    p = np.stack([u * scale[0], v * scale[1],
                  scale[2] * (np.sin(3 * u) + 0.2 * rng.randn(n))], 1)
    q = np.linalg.qr(rng.randn(3, 3))[0]
    return (p @ q.T + rng.randn(3)).astype(np.float32)


def _cloud(rng):
    """N points in S segments (and 48 points of another), each segment's
    membership mask [S, N]."""
    sizes = [900, 700, 400]
    pts = np.concatenate([_segment(rng, k) for k in sizes]
                         + [rng.rand(N - sum(sizes), 3).astype(np.float32)])
    lab = np.repeat(np.arange(S + 1), sizes + [N - sum(sizes)])
    perm = rng.permutation(N)
    pts, lab = pts[perm], lab[perm]
    return pts, np.stack([lab == s for s in range(S)])


def _keys(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    return keys, [jax.random.split(k) for k in keys]


@pytest.mark.parametrize("partial", [False, True])
def test_standardize_matches_jax(rng, partial):
    """Points, mean, R and std within 1e-5 on 8 segments, among them minor
    axes whose Jacobi eigenvector has a negative largest component (which
    linalg.smallest_eigvec's sign rule would flip). partial: fewer than 400
    weights above 0.8, the top-half rule."""
    segs = np.stack([_segment(rng, 1500) for _ in range(8)])
    w = np.ones(segs.shape[:2], np.float32)
    if partial:
        w[:, :1200] = 0.5
    ref = jax.vmap(jst.standardize_points)(jnp.asarray(segs), jnp.asarray(w))
    got = tst.standardize_points(torch.from_numpy(segs), torch.from_numpy(w))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)
    # R maps the minor axis onto x: its first row is that eigenvector
    minor = got.R[:, 0].numpy()
    big = minor[np.arange(8), np.argmax(np.abs(minor), 1)]
    assert (big < 0).any() and (big > 0).any(), minor
    back = tst.unstandardize_points(got.points, got)
    np.testing.assert_allclose(back.numpy(), segs, rtol=0, atol=1e-5)


def test_rotation_matrix_matches_jax(rng):
    a = rng.randn(6, 3).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    a[5] = [1.0, 0.0, 0.0]     # A = B: the ridge keeps it finite
    b = np.array([1.0, 0.0, 0.0], np.float32)
    ref = jax.vmap(lambda x: jst.rotation_matrix_a_to_b(
        x, jnp.asarray(b)))(jnp.asarray(a))
    got = tst.rotation_matrix_a_to_b(torch.from_numpy(a),
                                     torch.from_numpy(np.tile(b, (6, 1))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose((got[:5] @ torch.from_numpy(a[:5, :, None])
                                )[..., 0].numpy(), np.tile(b, (5, 1)),
                               atol=1e-5)


def test_pack_and_draw_match_jax(rng):
    """pack_segment and draw_fixed row for row, with the JAX draws."""
    pts, member = _cloud(rng)
    keys, _ = _keys(3)
    u = np.stack([np.asarray(jax.random.uniform(k, (N,))) for k in keys])
    ref = [jpp.pack_segment(jnp.asarray(pts), jnp.asarray(m), k)
           for m, k in zip(member, keys)]
    got_p, got_m = tpp.pack_segment(torch.from_numpy(pts),
                                    torch.from_numpy(member),
                                    torch.from_numpy(u))
    for s, (rp, rm) in enumerate(ref):
        np.testing.assert_array_equal(got_p[s].numpy(), np.asarray(rp))
        assert int(got_m[s]) == int(rm)
    for n_out, m_draw in ((1800, got_m), (1800, torch.tensor([500, 3, 0]))):
        ref = [jpp.draw_fixed(jnp.asarray(got_p[s].numpy()), int(m_draw[s]),
                              n_out, k) for s, k in enumerate(keys)]
        got = tpp.draw_fixed(got_p, m_draw, n_out, torch.from_numpy(u))
        for s, r in enumerate(ref):
            np.testing.assert_array_equal(got[s].numpy(), np.asarray(r))


def _jax_mean_dist(pts, m, nb=jpp.NB_NEIGHBORS):
    """The statistic statistical_inliers_packed thresholds, in float64:
    (mean distance [buf], threshold)."""
    p = pts[:m].astype(np.float64)
    d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    k = int(np.clip(m - 1, 1, nb))
    md = np.sort(d, 1)[:, :k].mean(1)
    return md, md.mean() + jpp.STD_RATIO * md.std()


def test_statistical_inliers_match_jax(rng):
    """Keep flags equal, except where a point's mean distance lies within
    1e-6 relative of the threshold (reported); repack row for row."""
    pts, member = _cloud(rng)
    pts = pts + np.where(rng.rand(N, 1) < 0.03, 0.3 * rng.randn(N, 3),
                         0.0).astype(np.float32)       # a few outliers
    keys, _ = _keys(4)
    u = np.stack([np.asarray(jax.random.uniform(k, (N,))) for k in keys])
    packed, m = tpp.pack_segment(torch.from_numpy(pts),
                                 torch.from_numpy(member), torch.from_numpy(u))
    got = tpp.statistical_inliers_packed(packed, m).numpy()
    near = []
    for s in range(S):
        ref = np.asarray(jpp.statistical_inliers_packed(
            jnp.asarray(packed[s].numpy()), jnp.int32(int(m[s]))))
        md, th = _jax_mean_dist(packed[s].numpy(), int(m[s]))
        close = np.zeros(N, bool)
        close[:int(m[s])] = np.abs(md - th) <= 1e-6 * th
        near += [(s, int(i)) for i in np.flatnonzero(close)]
        assert 0 < ref.sum() < int(m[s])
        np.testing.assert_array_equal(got[s][~close], ref[~close])
        rp, rm = jpp.repack(jnp.asarray(packed[s].numpy()), jnp.asarray(ref))
        gp, gm = tpp.repack(packed[s:s + 1], torch.from_numpy(ref[None]))
        np.testing.assert_array_equal(gp[0].numpy(), np.asarray(rp))
        assert int(gm[0]) == int(rm)
    print(f"points within 1e-6 relative of the threshold: {near}")


def _f32_ties(cand_a, cand_b, q, x, rel=2.5e-7):
    """Whether two neighbour selections of query q among points x [M, 3]
    differ only by a tie: their exact (float64) squared distances, sorted,
    agree within the rounding of the f32 expansion |q|^2 - 2 q.x + |x|^2
    (rel times |q|^2 + max |x|^2)."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    da = np.sort(((x[list(cand_a)] - q) ** 2).sum(-1))
    db = np.sort(((x[list(cand_b)] - q) ** 2).sum(-1))
    both = list(cand_a) + list(cand_b)
    scale = (q ** 2).sum() + (x[both] ** 2).sum(-1).max()
    return bool(np.all(np.abs(da - db) <= rel * scale))


@jax.jit
def _jax_nbr4(p, m):
    """The 4-NN indices one round of the JAX package's upsampling takes
    (ops/preprocess.py:124-133), on one packed buffer, compiled as its loop
    body is."""
    buf = p.shape[0]
    valid = jnp.arange(buf) < m
    d = (jnp.sum(p * p, -1, keepdims=True)
         - 2.0 * jnp.dot(p, p.T, preferred_element_type=jnp.float32)
         + jnp.sum(p * p, -1)[None, :])
    d = jnp.where(valid[None, :] & valid[:, None], d, jnp.float32(1e30))
    d = jnp.where(jnp.eye(buf, dtype=bool), jnp.float32(1e30), d)
    return jpp._nearest_k(-d, 4)[1]


def _upsample_rounds(packed, m, a_max):
    """The port's upsampling one round at a time, each round also through
    the JAX package from the same state, whose centroids must agree within
    1e-5 except where the 4-NN sets differ. -> (final pts, m, rounds), a
    round being (m before, [(slot, appended row, port set, JAX set)] where
    the sets differ, the state, the port's 4-NN indices)."""
    rounds = []
    pts = packed.clone()
    while bool((m < a_max).any()) and len(rounds) < tpp.UPSAMPLE_ROUNDS:
        nbr_t = tknn.topk_first(-tpp._masked_sqdist(pts, m), 4)
        diff = []
        for s in range(pts.shape[0]):
            ms = int(m[s])
            if ms >= int(a_max[s]):
                continue
            nbr_j = np.asarray(_jax_nbr4(jnp.asarray(pts[s].numpy()),
                                         jnp.int32(ms)))
            for r in range(min(ms, pts.shape[1] - ms)):
                a, b = set(nbr_t[s, r].tolist()), set(nbr_j[r].tolist())
                if a != b:
                    diff.append((s, r, a, b))
        rounds.append((m.clone(), diff, pts.clone(), nbr_t))
        step, m_new = tpp.nn_centroid_upsample(pts, m, a_max, rounds=1)
        for s in range(pts.shape[0]):
            if int(m[s]) >= int(a_max[s]):
                continue
            ref, ref_m = jpp.nn_centroid_upsample(
                jnp.asarray(pts[s].numpy()), jnp.int32(int(m[s])),
                jnp.int32(int(a_max[s])), rounds=1)
            assert int(ref_m) == int(m_new[s])
            ok = np.ones(pts.shape[1], bool)
            ok[[int(m[s]) + r for t, r, _, _ in diff if t == s]] = False
            np.testing.assert_allclose(step[s].numpy()[ok],
                                       np.asarray(ref)[ok], rtol=0, atol=1e-5)
        pts, m = step, m_new
    return pts, m, rounds


def test_upsample_rounds_match_jax(rng):
    """NN-centroid doubling round by round, each round from the same state:
    the centroids within 1e-5 of the JAX package's, except rows whose 4-NN
    set differs, each shown to be a tie by its distances."""
    pts, member = _cloud(rng)
    keys, _ = _keys(5)
    u = np.stack([np.asarray(jax.random.uniform(k, (N,))) for k in keys])
    packed, m = tpp.pack_segment(torch.from_numpy(pts),
                                 torch.from_numpy(member), torch.from_numpy(u))
    m = torch.tensor([600, 333, 100])
    a_max = torch.tensor([1800, 1500, 1800])
    _, m_out, rounds = _upsample_rounds(packed, m, a_max)
    assert m_out.tolist() == [2048] * 3 and len(rounds) == 5
    for i, (_, diff, state, _) in enumerate(rounds):
        for s, r, a, b in diff:
            x = state[s].numpy()
            assert _f32_ties(a, b, x[r], x), (i, s, r, a, b)
        print(f"round {i + 1}: 4-NN sets decided by ties at (slot, row) "
              f"{[(s, r) for s, r, _, _ in diff]}")


def test_eval_segment_points_matches_jax(rng):
    """The whole preprocessing of 3 slots (a_max 1,800 closed and 1,500
    open) against the JAX package's, with its split keys' draws: rows drawn
    from the segment's own points equal, synthetic rows within 1e-5 except
    those a 4-NN tie (shown round by round) feeds, directly or through a
    neighbour."""
    pts, member = _cloud(rng)
    keys, split = _keys(6)
    a_max = np.array([1800, 1500, 1800])
    ref = np.stack([np.asarray(jpp.eval_segment_points(
        jnp.asarray(pts), jnp.asarray(member[s]), jnp.int32(a_max[s]),
        keys[s], n_out=1800)) for s in range(S)])
    u_pack = torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k1, (N,))) for k1, _ in split]))
    u_draw = torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k2, (tpp.BUF,))) for _, k2 in split]))
    got = tpp.eval_segment_points(torch.from_numpy(pts),
                                  torch.from_numpy(member),
                                  torch.from_numpy(a_max), u_pack, u_draw,
                                  n_out=1800).numpy()
    # the same through the pieces, keeping the provenance of every row
    packed, m = tpp.pack_segment(torch.from_numpy(pts),
                                 torch.from_numpy(member), u_pack)
    packed, m0 = tpp.repack(packed, tpp.statistical_inliers_packed(packed, m))
    up, m_up, rounds = _upsample_rounds(packed, m0, torch.from_numpy(a_max))
    np.testing.assert_array_equal(
        tpp.draw_fixed(up, m_up, 1800, u_draw).numpy(), got)
    # rows a tie may feed: a centroid whose 4-NN set differed, or whose 4th
    # and 5th neighbours tie within f32 rounding (the JAX package's state
    # differs from the port's in the last bits after the first round), and,
    # in later rounds, every row with such a row among its 16 nearest
    tainted = np.zeros((S, N), bool)
    for m_i, diff, state, _ in rounds:
        near = torch.topk(-tpp._masked_sqdist(state, m_i), 16,
                          dim=-1).indices.numpy()
        for s in range(S):
            mi = int(m_i[s])
            if mi >= a_max[s]:
                continue
            p = state[s, :mi].numpy().astype(np.float64)
            d = ((p[:, None] - p[None]) ** 2).sum(-1)
            np.fill_diagonal(d, np.inf)
            d45 = np.sort(d, 1)[:, 3:5]
            scale = (p ** 2).sum(-1) + (p ** 2).sum(-1).max()
            tie = d45[:, 1] - d45[:, 0] <= 2.5e-7 * scale
            for r in range(min(mi, N - mi)):
                tainted[s, mi + r] = tie[r] or tainted[s, near[s, r]].any()
    valid = torch.arange(N)[None] < m_up[:, None]
    order = torch.argsort(u_draw + torch.where(valid, 0.0, 2.0), dim=1,
                          stable=True)
    src = torch.gather(order, 1, torch.arange(1800)[None] % m_up[:, None])
    for s in range(S):
        own = src[s].numpy() < int(m0[s])
        np.testing.assert_array_equal(got[s][own], ref[s][own])
        ok = ~tainted[s, src[s].numpy()]
        np.testing.assert_allclose(got[s][ok], ref[s][ok], rtol=0, atol=1e-5)
        print(f"slot {s}: {int((~own).sum())} synthetic rows, "
              f"{int((~ok).sum())} fed by a 4-NN tie")


def _loop_knn(x, k1, k2):
    """The port's kNN before it was batched: one cloud at a time."""
    out = []
    for xb in x:
        xx = torch.sum(xb * xb, dim=-1)
        neg = 2.0 * (xb @ xb.T) - torch.sum(xb * xb, -1, keepdim=True) - xx
        out.append(tknn._topk_neighbors(neg, k1, k2))
    return torch.stack(out)


def _sets(idx):
    return [frozenset(r) for r in np.asarray(idx).reshape(-1, idx.shape[-1])]


def _assert_sets_match_jax(got, ref, x, tie):
    """Neighbour sets equal to the JAX package's, except rows whose two
    selections differ only by a tie of their f32 distances (printed)."""
    ties = []
    for b in range(x.shape[0]):
        for i in range(x.shape[1]):
            a, r = set(got[b, i].tolist()), set(ref[b, i].tolist())
            if a != r:
                assert tie(a, r, x[b], i), (b, i, a, r)
                ties.append((b, i))
    print(f"rows decided by ties: {ties}")


@pytest.mark.parametrize("shape,k1,k2", [((36, 448, 3), 10, 10),
                                         ((3, 1800, 64), 10, 10),
                                         ((2, 1024, 6), 10, 20),
                                         ((2, 2048, 3), 80, 80)])
def test_batched_knn_matches_loop_and_jax(rng, shape, k1, k2):
    """Neighbour sets of the batched kNN equal the per-cloud loop's and the
    JAX package's (exact top-k on the CPU)."""
    x = rng.randn(*shape).astype(np.float32)
    got = tknn.knn(torch.from_numpy(x), k1, k2)
    assert got.shape == (*shape[:2], k1)
    assert _sets(got.numpy()) == _sets(_loop_knn(torch.from_numpy(x), k1,
                                                 k2).numpy())
    _assert_sets_match_jax(got.numpy(), np.asarray(jknn.knn(
        jnp.asarray(x), k1, k2)), x, lambda a, r, xb, i: _f32_ties(
            a, r, xb[i], xb))


def test_batched_knn_points_normals_matches_jax(rng):
    x = rng.randn(3, 1000, 6).astype(np.float32)
    x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    got = tknn.knn_points_normals(torch.from_numpy(x), 20, 40)
    _assert_sets_match_jax(got.numpy(), np.asarray(jknn.knn_points_normals(
        jnp.asarray(x), 20, 40)), x, _joint_ties)


def _joint_ties(cand_a, cand_b, xb, i, rel=2.5e-7):
    """_f32_ties for the joint metric d_p (1 + d_n) of knn_points_normals
    (d_n = 2 - 2 n_i.n_j <= 4, so the scale grows by 5)."""
    p, nrm = xb[:, :3].astype(np.float64), xb[:, 3:].astype(np.float64)

    def dist(c):
        c = list(c)
        d_p = ((p[c] - p[i]) ** 2).sum(-1)
        return np.sort(d_p * (3.0 - 2.0 * nrm[c] @ nrm[i]))
    scale = 5.0 * ((p[i] ** 2).sum() + (p ** 2).sum(-1).max())
    return bool(np.all(np.abs(dist(cand_a) - dist(cand_b)) <= rel * scale))


@pytest.mark.parametrize("k", [1, 4, 10, 40])
def test_topk_first_orders_ties_like_top_k(rng, k):
    """topk_first: lax.top_k's order, equal values by ascending index, also
    where a tie at the k-th value reaches past its candidates."""
    x = rng.randint(0, 5, (200, 50)).astype(np.float32)
    x[0] = 1.0                 # one row all tied
    np.testing.assert_array_equal(
        tknn.topk_first(torch.from_numpy(x), k).numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))


def test_topk_first_orders_signed_zeros_like_top_k():
    """topk_first: lax.top_k's total order, +0.0 above -0.0 and each by
    ascending index, negative values below both."""
    x = np.array([[-0.0, 0.0, -1.5, -0.0, 0.0, 2.0, -1.5]], np.float32)
    np.testing.assert_array_equal(
        tknn.topk_first(torch.from_numpy(x), 7).numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(x), 7)[1]))
