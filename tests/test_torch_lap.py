"""Port parity: K2's plain versions (the benefit entry auction_assign and
the whole-solve entry lap_assign) against the Pallas auction kernel
(interpret mode), solve_lap and SIOU matching, one shape and batched,
against the JAX package; the batched SIOU of predict_segmentation against
the per-shape calls."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops import hungarian as jhg
from parsenet_tpu.ops import segmentation as jseg
from parsenet_tpu.ops.pallas_kernels import auction_assign_pallas
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.ops import hungarian as thg
from parsenet_tpu_torch.ops import kernels
from parsenet_tpu_torch.ops import segmentation as tseg
from parsenet_tpu_torch.ops.mean_shift import guard_mean_shift

torch.set_num_threads(1)


def _siou_cost(n=50):
    """SIOU-structured cost: 8 real segments with a strong preference, the
    rest uniform (empty predicted segments), as tests/test_pallas.py."""
    cost = np.ones((n, n), np.float32)
    for i in range(8):
        cost[i, (i * 3) % n] = 0.1 * i / 8.0
    return cost


def _pallas(benefit, max_iter):
    return np.asarray(auction_assign_pallas(
        jnp.asarray(benefit), jhg._EPS0, jhg._ESC_EVERY, jhg._ESC, max_iter,
        interpret=True))


@pytest.mark.parametrize("n", [10, 50])
def test_k2_plain_matches_pallas_random(rng, n):
    for _ in range(2):
        benefit = thg.lap_benefit(torch.from_numpy(
            rng.rand(n, n).astype(np.float32)))
        got = kernels.auction_assign_plain(benefit, thg._EPS0, thg._ESC_EVERY,
                                           thg._ESC, 3000)
        np.testing.assert_array_equal(got.numpy(),
                                      _pallas(benefit.numpy(), 3000))


def test_k2_plain_matches_pallas_siou():
    benefit = thg.lap_benefit(torch.from_numpy(_siou_cost()))
    got = kernels.auction_assign_plain(benefit, thg._EPS0, thg._ESC_EVERY,
                                       thg._ESC, 3000)
    np.testing.assert_array_equal(got.numpy(), _pallas(benefit.numpy(), 3000))
    assert sorted(got.tolist()) == list(range(50))


def test_k2_bailout_returns_minus_one(rng):
    benefit = thg.lap_benefit(torch.from_numpy(
        rng.rand(50, 50).astype(np.float32)))
    got = kernels.auction_assign_plain(benefit, thg._EPS0, thg._ESC_EVERY,
                                       thg._ESC, 5)
    ref = _pallas(benefit.numpy(), 5)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == -1).any()
    done = thg.complete_assignment(got)
    assert sorted(done.tolist()) == list(range(50))


def test_k2_batched_equals_single(rng):
    benefit = thg.lap_benefit(torch.from_numpy(
        rng.rand(3, 20, 20).astype(np.float32)))
    batched = kernels.auction_assign(benefit, thg._EPS0, thg._ESC_EVERY,
                                     thg._ESC, 3000)
    for i in range(3):
        np.testing.assert_array_equal(
            batched[i].numpy(),
            kernels.auction_assign(benefit[i], thg._EPS0, thg._ESC_EVERY,
                                   thg._ESC, 3000).numpy())


@pytest.mark.parametrize("kind", ["random", "siou"])
def test_solve_lap_matches_jax(rng, kind):
    cost = (rng.rand(50, 50).astype(np.float32) if kind == "random"
            else _siou_cost())
    got = thg.solve_lap(torch.from_numpy(cost)).numpy()
    ref = np.asarray(jhg.solve_lap(jnp.asarray(cost)))
    assert sorted(got.tolist()) == list(range(50))
    np.testing.assert_allclose(cost[np.arange(50), got].sum(),
                               cost[np.arange(50), ref].sum(), atol=5e-3)


def test_siou_matched_segments_matches_jax(rng):
    n = 2000
    gt = rng.randint(0, 9, n)
    pred = np.where(rng.rand(n) < 0.9, (gt * 3 + 1) % 12, rng.randint(0, 12, n))
    gt_prim = rng.randint(0, 10, n)
    pred_prim = np.where(rng.rand(n) < 0.8, gt_prim, rng.randint(0, 10, n))
    ref = jseg.siou_matched_segments(
        jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(pred_prim),
        jnp.asarray(gt_prim), jseg.to_one_hot(jnp.asarray(pred)),
        min_gt_points=100)
    p = torch.from_numpy(pred)
    got = tseg.siou_matched_segments(
        torch.from_numpy(gt), p, torch.from_numpy(pred_prim),
        torch.from_numpy(gt_prim), tseg.to_one_hot(p), min_gt_points=100)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)


def test_segmentation_helpers_match_jax(rng):
    labels = rng.randint(0, 60, 500)   # ids past K_MAX give zero rows
    np.testing.assert_array_equal(
        tseg.to_one_hot(torch.from_numpy(labels)).numpy(),
        np.asarray(jseg.to_one_hot(jnp.asarray(labels))))
    prim = rng.randint(0, 10, 500)
    np.testing.assert_array_equal(
        tseg.remap_primitive_labels(torch.from_numpy(prim)).numpy(),
        np.asarray(jseg.remap_primitive_labels(jnp.asarray(prim))))
    a = rng.rand(500, 50).astype(np.float32)
    b = rng.rand(500, 50).astype(np.float32)
    np.testing.assert_allclose(
        tseg.relaxed_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jseg.relaxed_iou(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5)


def _jax_benefit(cost):
    """The benefit parsenet_tpu/ops/hungarian.solve_lap builds, in JAX."""
    n = cost.shape[0]
    cost = jnp.asarray(cost, jnp.float32)
    uniform = (jnp.max(cost, axis=1) - jnp.min(cost, axis=1)) <= 1e-6
    tie = jhg._TIE * jnp.arange(n, dtype=jnp.float32)[None, :]
    park = jhg._BETA * uniform[:, None] * jnp.eye(n, dtype=jnp.float32)
    return -(cost + tie) + park


def _jax_complete(assignment):
    """solve_lap's rank fill of the rows left unassigned, in JAX."""
    a = jnp.asarray(assignment)
    n = a.shape[0]
    assigned = a >= 0
    col_taken = jnp.zeros((n,), bool).at[
        jnp.where(assigned, a, n)].set(True, mode="drop")
    free_cols = jnp.sort(jnp.where(col_taken, n, jnp.arange(n)))
    fill = free_cols[jnp.clip(jnp.cumsum(~assigned) - 1, 0, n - 1)]
    return np.asarray(jnp.where(assigned, a, fill).astype(jnp.int32))


def _costs(rng, kind, b, n):
    """[b, n, n] costs: uniform random, or SIOU-structured (a few real
    segments with a strong preference each, the other rows uniform)."""
    if kind == "random":
        return rng.rand(b, n, n).astype(np.float32)
    cost = np.ones((b, n, n), np.float32)
    for k in range(b):
        for i in range(min(8, n - 1)):
            cost[k, i, (i * 3 + k) % n] = 0.1 * i / 8.0 + 0.01 * k
    return cost


@pytest.mark.parametrize("n", [10, 50])
@pytest.mark.parametrize("kind", ["random", "siou"])
def test_lap_assign_plain_matches_jax(rng, n, kind):
    """K2's whole-solve entry on a batch, against the JAX package's
    solve_lap on each matrix and against the Pallas kernel (interpret mode)
    on JAX's own benefit followed by JAX's completion: equal permutations."""
    cost = _costs(rng, kind, 2, n)
    got = kernels.lap_assign_plain(torch.from_numpy(cost), thg._EPS0,
                                   thg._ESC_EVERY, thg._ESC, 3000).numpy()
    assert got.shape == (2, n) and got.dtype == np.int32
    for k in range(2):
        np.testing.assert_array_equal(
            got[k], np.asarray(jhg.solve_lap(jnp.asarray(cost[k]))))
        np.testing.assert_array_equal(
            got[k], _jax_complete(_pallas(_jax_benefit(cost[k]), 3000)))
        assert sorted(got[k].tolist()) == list(range(n))


def test_lap_assign_plain_bailout_matches_pallas(rng):
    """At a round cap that leaves persons unassigned, the rank fill gives
    the Pallas kernel's assignment completed as the JAX package does."""
    cost = _costs(rng, "random", 2, 50)
    got = kernels.lap_assign_plain(torch.from_numpy(cost), thg._EPS0,
                                   thg._ESC_EVERY, thg._ESC, 5).numpy()
    for k in range(2):
        raw = _pallas(_jax_benefit(cost[k]), 5)
        assert (raw == -1).any()
        np.testing.assert_array_equal(got[k], _jax_complete(raw))


def test_solve_lap_batched_equals_single(rng):
    cost = torch.from_numpy(_costs(rng, "random", 3, 20))
    batched = thg.solve_lap(cost)
    assert batched.shape == (3, 20)
    for k in range(3):
        np.testing.assert_array_equal(batched[k].numpy(),
                                      thg.solve_lap(cost[k]).numpy())


@pytest.mark.parametrize("entry", ["auction_assign", "lap_assign"])
def test_k2_entries_reject_what_the_kernel_cannot_take(entry):
    """Off the CPU a K2 entry takes float32 [n, n] / [B, n, n] with n <= 64
    and raises on anything else, before it would launch; a valid input on
    a device that is not CUDA raises too (no plain fallback)."""
    fn = getattr(kernels, entry)
    args = (thg._EPS0, thg._ESC_EVERY, thg._ESC, 100)
    with pytest.raises(ValueError, match="n <= 64"):
        fn(torch.empty((2, 65, 65), device="meta"), *args)
    with pytest.raises(ValueError, match="float32"):
        fn(torch.empty((2, 8, 8), dtype=torch.float64, device="meta"), *args)
    with pytest.raises(ValueError, match="float32"):
        fn(torch.empty((2, 8, 9), device="meta"), *args)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(torch.empty((2, 8, 8), device="meta"), *args)
    # the plain version takes any n on the CPU
    cost = torch.rand((1, 65, 65), generator=torch.Generator().manual_seed(0))
    out = fn(cost, *args)
    assert out.shape == (1, 65)


def _siou_inputs(rng, b, n):
    gt = rng.randint(0, 9, (b, n))
    pred = np.where(rng.rand(b, n) < 0.9, (gt * 3 + 1) % 12,
                    rng.randint(0, 12, (b, n)))
    gt_prim = rng.randint(0, 10, (b, n))
    pred_prim = np.where(rng.rand(b, n) < 0.8, gt_prim,
                         rng.randint(0, 10, (b, n)))
    return gt, pred, gt_prim, pred_prim


def test_siou_batched_matches_per_shape_and_jax(rng):
    """A batch of 3 shapes in one call: each shape's (seg_iou, prim_iou)
    bitwise the one-shape call's, and within 1e-6 of the JAX package's
    (the same tolerance as the one-shape test: f32 sums in another
    order)."""
    gt, pred, gt_prim, pred_prim = _siou_inputs(rng, 3, 2000)
    t = [torch.from_numpy(a) for a in (gt, pred, pred_prim, gt_prim)]
    seg, prim = tseg.siou_matched_segments(
        t[0], t[1], t[2], t[3], tseg.to_one_hot(t[1]), min_gt_points=100)
    assert seg.shape == (3,) and prim.shape == (3,)
    for k in range(3):
        one = tseg.siou_matched_segments(
            t[0][k], t[1][k], t[2][k], t[3][k], tseg.to_one_hot(t[1][k]),
            min_gt_points=100)
        assert one[0].shape == () and one[1].shape == ()
        np.testing.assert_array_equal(seg[k].numpy(), one[0].numpy())
        np.testing.assert_array_equal(prim[k].numpy(), one[1].numpy())
        ref = jseg.siou_matched_segments(
            jnp.asarray(gt[k]), jnp.asarray(pred[k]),
            jnp.asarray(pred_prim[k]), jnp.asarray(gt_prim[k]),
            jseg.to_one_hot(jnp.asarray(pred[k])), min_gt_points=100)
        np.testing.assert_allclose(float(seg[k]), float(ref[0]), atol=1e-6)
        np.testing.assert_allclose(float(prim[k]), float(ref[1]), atol=1e-6)


def test_predict_segmentation_siou_is_per_shape(rng):
    """predict_segmentation clusters each shape, then runs SIOU once for
    the batch: labels, seg_iou and prim_iou equal (bitwise) those of
    guard_mean_shift and the one-shape SIOU call shape by shape, the
    pipeline's order before SIOU was batched."""
    b, n, s = 3, 900, 300
    gt = rng.randint(0, 6, (b, n))
    gt_prim = rng.randint(0, 10, (b, n))
    centres = rng.randn(8, 16).astype(np.float32)
    emb = centres[gt] + 0.05 * rng.randn(b, n, 16).astype(np.float32)
    logp = rng.randn(b, n, 10).astype(np.float32)
    subsets = torch.from_numpy(
        np.stack([rng.permutation(n)[:s] for _ in range(b)]))
    pts = rng.randn(b, n, 3).astype(np.float32)

    def model(x):
        assert x.shape == (b, n, 6)
        return torch.from_numpy(emb), torch.from_numpy(logp)

    out = tp.predict_segmentation(model, pts, pts, gt, gt_prim,
                                  ms_num_samples=s, iterations=10,
                                  subsets=subsets, device="cpu")
    e = torch.from_numpy(emb)
    e = e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-12)
    pred_prim = torch.argmax(torch.from_numpy(logp), dim=-1)
    for k in range(b):
        ms = guard_mean_shift(e[k], 0.015, num_samples=s, iterations=10,
                              subset=subsets[k])
        seg, prim = tseg.siou_matched_segments(
            torch.from_numpy(gt[k]), ms.labels, pred_prim[k],
            torch.from_numpy(gt_prim[k]), tseg.to_one_hot(ms.labels))
        np.testing.assert_array_equal(out.labels[k].numpy(),
                                      ms.labels.numpy())
        np.testing.assert_array_equal(out.seg_iou[k].numpy(), seg.numpy())
        np.testing.assert_array_equal(out.prim_iou[k].numpy(), prim.numpy())
        assert out.num_clusters[k] == ms.num_clusters
    assert float(out.seg_iou.min()) > 0.5
