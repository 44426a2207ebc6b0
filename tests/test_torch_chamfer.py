"""Port parity: K3's plain version against the Pallas min-sqdist kernel
(interpret mode), K4 (MinSqdist's backward) against min_sqdist_fused's
VJP, the chamfer distances against the JAX package, and the
reference-protocol coverage with the same uniforms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


# ---------------------------------------------------------------------------
# K3 batched, K4 (MinSqdist) and the chamfer distances of the training path
# ---------------------------------------------------------------------------

from parsenet_tpu.ops import chamfer as jch  # noqa: E402
from parsenet_tpu.ops.pallas_kernels import min_sqdist_fused  # noqa: E402
from parsenet_tpu_torch.ops import chamfer as tch  # noqa: E402


def test_k3_plain_batched_matches_pallas(rng):
    """One batched plain call against jax.vmap of the Pallas kernel, which
    is how the TPU path batches it."""
    q = rng.randn(3, 100, 3).astype(np.float32)
    x = rng.randn(3, 160, 3).astype(np.float32)
    mask = (rng.rand(3, 160) < 0.7).astype(np.float32)
    ref_d, ref_i = jax.vmap(lambda a, b, m: min_sqdist_with_idx_pallas(
        a, b, m, interpret=True))(jnp.asarray(q), jnp.asarray(x),
                                  jnp.asarray(mask))
    d, i = kernels.min_sqdist_with_idx(torch.from_numpy(q),
                                       torch.from_numpy(x),
                                       torch.from_numpy(mask))
    assert d.shape == (3, 100) and i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-6)
    for b in range(3):
        keep = mask[b] > 0
        uniq = _unique_min(q[b], x[b][keep])
        np.testing.assert_array_equal(i.numpy()[b][uniq],
                                      np.asarray(ref_i)[b][uniq])


def _k4_grads(q, x, g):
    qt = torch.from_numpy(q).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    if q.ndim == 2:
        d = tch.min_sqdist(qt, xt)
    else:
        d = kernels.MinSqdist.apply(qt, xt)
    (d * torch.from_numpy(g)).sum().backward()
    return d.detach().numpy(), qt.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("shape", [(40, 90), (3, 100, 160)])
def test_k4_gradients_match_pallas_vjp(rng, shape):
    """K4's plain version through MinSqdist against min_sqdist_fused's
    custom VJP (interpret mode), with a random incoming gradient: 1e-5
    relative and absolute, as tests/test_pallas.py holds the VJP."""
    lead, n, m = (shape[:-2], shape[-2], shape[-1])
    q = rng.randn(*lead, n, 3).astype(np.float32)
    x = rng.randn(*lead, m, 3).astype(np.float32)
    g = rng.rand(*lead, n).astype(np.float32)

    def f(a, b):
        fn = lambda a_, b_: min_sqdist_fused(a_, b_, None, True)
        d = jax.vmap(fn)(a, b) if a.ndim == 3 else fn(a, b)
        return jnp.sum(d * jnp.asarray(g))

    rq, rx = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(x))
    _, gq, gx = _k4_grads(q, x, g)
    np.testing.assert_allclose(gq, np.asarray(rq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx, np.asarray(rx), rtol=1e-5, atol=1e-5)
    assert np.abs(gx).max() > 0


def test_k4_masked_targets_get_no_gradient(rng):
    q = rng.randn(2, 30, 3).astype(np.float32)
    x = rng.randn(2, 50, 3).astype(np.float32)
    mask = np.ones((2, 50), np.float32)
    mask[:, ::3] = 0
    xt = torch.from_numpy(x).requires_grad_()
    tch.min_sqdist(torch.from_numpy(q), xt, torch.from_numpy(mask)).sum() \
        .backward()
    assert float(xt.grad[:, ::3].abs().max()) == 0.0
    assert float(xt.grad.abs().max()) > 0.0


@pytest.mark.parametrize("sqrt", [False, True])
def test_chamfer_distance_matches_jax(rng, sqrt):
    x = rng.randn(2, 64, 3).astype(np.float32)
    y = rng.randn(2, 48, 3).astype(np.float32)
    y_mask = (rng.rand(2, 48) < 0.8).astype(np.float32)

    def jf(a, b):
        return jch.chamfer_distance(a, b, None, jnp.asarray(y_mask),
                                    sqrt=sqrt)

    ref, (rgx, rgy) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    got = tch.chamfer_distance(xt, yt, None, torch.from_numpy(y_mask),
                               sqrt=sqrt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(rgy), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("side", [0, 1])
def test_chamfer_one_side_matches_jax(rng, side):
    """The spline training loss direction (side 1) and its reverse:
    values 1e-5 relative, gradients 1e-4 relative."""
    x = rng.randn(3, 80, 3).astype(np.float32)
    y = rng.randn(3, 50, 3).astype(np.float32)
    ref, (rgx, rgy) = jax.value_and_grad(
        lambda a, b: jch.chamfer_distance_one_side(a, b, side=side),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    got = tch.chamfer_distance_one_side(xt, yt, side=side)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(rgy), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("one_side", [False, True])
def test_chamfer_single_shape_matches_jax(rng, one_side):
    x = rng.randn(70, 3).astype(np.float32)
    y = rng.randn(40, 3).astype(np.float32)
    ref = jch.chamfer_distance_single_shape(jnp.asarray(x), jnp.asarray(y),
                                            sqrt=True, one_side=one_side)
    got = tch.chamfer_distance_single_shape(torch.from_numpy(x),
                                            torch.from_numpy(y), sqrt=True,
                                            one_side=one_side)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_kernels_without_backward_refuse_inputs_that_require_grad(rng):
    """The rule is the dispatch helper's, so it holds on every device: an
    input that requires grad raises while grad mode is on, and passes under
    torch.no_grad(). MinSqdist is the differentiable route."""
    q = torch.from_numpy(rng.randn(20, 3).astype(np.float32))
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        kernels._on_cuda("any kernel", q, qg)
    with pytest.raises(ValueError, match="requires grad"):
        kernels._on_cuda("any kernel", q, scalars=(torch.ones((),
                                                   requires_grad=True),))
    assert kernels._on_cuda("any kernel", q, scalars=(0.5,)) is False
    with torch.no_grad():
        assert kernels._on_cuda("any kernel", qg) is False
    e = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(16, 8).astype(np.float32)), dim=1)
    calls = [
        lambda: kernels.min_sqdist_with_idx(qg, q),
        lambda: kernels.mean_shift_iterations(e.requires_grad_(), 0.5, 2),
        lambda: kernels.mean_shift_iterations(
            e.detach(), torch.tensor(0.5, requires_grad=True), 2),
        lambda: kernels.mean_shift_step(e.detach(), e.detach(),
                                        torch.tensor(2.0,
                                                     requires_grad=True)),
        lambda: kernels.auction_assign(torch.rand(6, 6, requires_grad=True),
                                       1e-5, 150, 8.0, 10),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="requires grad"):
            call()
    with torch.no_grad():
        for call in calls:
            call()
    d = tch.min_sqdist(qg, q + 1.0)
    d.sum().backward()
    assert d.grad_fn is not None and float(qg.grad.abs().max()) > 0
