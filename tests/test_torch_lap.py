"""Port parity: K2's plain version against the Pallas auction kernel
(interpret mode), solve_lap and SIOU matching against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.ops import hungarian as jhg
from parsenet_tpu.ops import segmentation as jseg
from parsenet_tpu.ops.pallas_kernels import auction_assign_pallas
from parsenet_tpu_torch.ops import hungarian as thg
from parsenet_tpu_torch.ops import kernels
from parsenet_tpu_torch.ops import segmentation as tseg

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
