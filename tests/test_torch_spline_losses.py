"""Port parity: the SplineNet losses (losses/spline.py) against the JAX
package: the permutation-min control-point losses (value, best-permuted
grid and gradient), the Laplacian loss and both reconstruction losses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.losses import spline as jls
from parsenet_tpu_torch.losses import spline as tls
from parsenet_tpu_torch.ops.bspline import uniform_knot_bspline

torch.set_num_threads(1)

G = 6


def _grids(rng, b=3):
    cp = rng.randn(b, G, G, 3).astype(np.float32)
    # predictions near a random symmetry of the gt, so the min is decided
    flip = np.flip(cp, axis=1) if b else cp
    out = (flip + 0.05 * rng.randn(*cp.shape)).astype(np.float32)
    return out.reshape(b, G * G, 3), cp


@pytest.mark.parametrize("closed", [False, True])
def test_permutation_loss_matches_jax(rng, closed):
    """Value 1e-6 relative, the best-permuted grid exactly, the gradient
    w.r.t. the prediction 1e-5."""
    out, cp = _grids(rng)
    jfn = (jls.control_points_permute_closed_reg_loss if closed
           else jls.control_points_permute_reg_loss)
    tfn = (tls.control_points_permute_closed_reg_loss if closed
           else tls.control_points_permute_reg_loss)
    (ref, ref_best), ref_g = jax.value_and_grad(
        lambda o: jfn(o, jnp.asarray(cp), G), has_aux=True)(jnp.asarray(out))
    ot = torch.from_numpy(out).requires_grad_()
    loss, best = tfn(ot, torch.from_numpy(cp), G)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    np.testing.assert_array_equal(best.numpy(), np.asarray(ref_best))
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-7)


def test_permutation_stacks_match_jax(rng):
    cp = rng.randn(2, G, G, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tls.all_permutations(torch.from_numpy(cp)).numpy(),
        np.asarray(jls.all_permutations(jnp.asarray(cp))))
    np.testing.assert_array_equal(
        tls.all_permutations_half(torch.from_numpy(cp)).numpy(),
        np.asarray(jls.all_permutations_half(jnp.asarray(cp))))


def test_closed_loss_finds_a_cyclic_roll(rng):
    _, cp = _grids(rng, b=2)
    rolled = np.roll(np.flip(cp, axis=2), 4, axis=1).copy()
    loss, best = tls.control_points_permute_closed_reg_loss(
        torch.from_numpy(rolled.reshape(2, G * G, 3)), torch.from_numpy(cp),
        G)
    assert loss.item() == 0.0
    np.testing.assert_array_equal(best.numpy(), rolled)


def test_laplacian_loss_matches_jax(rng):
    a = rng.randn(3, G, G, 3).astype(np.float32)
    b = rng.randn(3, G, G, 3).astype(np.float32)
    ref, ref_g = jax.value_and_grad(jls.laplacian_loss)(jnp.asarray(a),
                                                        jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_()
    got = tls.laplacian_loss(at, torch.from_numpy(b))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("two_sided", [False, True])
def test_reconstruction_losses_match_jax(rng, two_sided):
    """The sampled surface and the chamfer to the points: surface 1e-6,
    loss 1e-5 relative, gradient w.r.t. the control grid 1e-4."""
    nu, nv = uniform_knot_bspline(G, G, 3, 3, 12)
    out = (0.5 * rng.randn(2, G * G, 3)).astype(np.float32)
    pts = (0.5 * rng.randn(2, 90, 3)).astype(np.float32)
    if two_sided:
        jfn = lambda o: jls.spline_reconstruction_loss(
            jnp.asarray(nu), jnp.asarray(nv), o, jnp.asarray(pts), sqrt=True)
        tfn = lambda o: tls.spline_reconstruction_loss(
            torch.from_numpy(nu), torch.from_numpy(nv), o,
            torch.from_numpy(pts), sqrt=True)
    else:
        jfn = lambda o: jls.spline_reconstruction_loss_one_sided(
            jnp.asarray(nu), jnp.asarray(nv), o, jnp.asarray(pts))
        tfn = lambda o: tls.spline_reconstruction_loss_one_sided(
            torch.from_numpy(nu), torch.from_numpy(nv), o,
            torch.from_numpy(pts))
    (ref, ref_recon), ref_g = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(out))
    ot = torch.from_numpy(out).requires_grad_()
    loss, recon = tfn(ot)
    loss.backward()
    assert recon.shape == (2, 144, 3)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(ref_recon),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-7)
