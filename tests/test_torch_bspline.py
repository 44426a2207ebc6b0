"""Port parity: the B-spline basis and surface sampling (ops/bspline.py),
and the synthetic spline patches built on them (data/synthetic.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.data import synthetic as jsyn
from parsenet_tpu.ops import bspline as jbs
from parsenet_tpu_torch.data import synthetic as tsyn
from parsenet_tpu_torch.ops import bspline as tbs

torch.set_num_threads(1)


@pytest.mark.parametrize("args", [(20, 20, 3, 3, 40), (10, 8, 3, 2, 20)])
def test_basis_matrices_bitwise_equal(args):
    for a, b in zip(tbs.uniform_knot_bspline(*args),
                    jbs.uniform_knot_bspline(*args)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_sample_surface_and_close_grid_match_jax(rng):
    nu, nv = tbs.uniform_knot_bspline(10, 10, 3, 3, 20)
    cp = rng.randn(3, 10, 10, 3).astype(np.float32)
    ref = jbs.sample_surface(jnp.asarray(nu), jnp.asarray(nv), jnp.asarray(cp))
    got = tbs.sample_surface(torch.from_numpy(nu), torch.from_numpy(nv),
                             torch.from_numpy(cp))
    assert got.shape == (3, 400, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    closed = tbs.close_control_grid(torch.from_numpy(cp))
    np.testing.assert_array_equal(
        closed.numpy(), np.asarray(jbs.close_control_grid(jnp.asarray(cp))))
    assert closed.shape == (3, 11, 10, 3)


@pytest.mark.parametrize("closed", [False, True])
def test_make_spline_batch_bitwise_equal(closed):
    ref = jsyn.make_spline_batch(np.random.RandomState(3), 3, 128, 10, closed)
    got = tsyn.make_spline_batch(np.random.RandomState(3), 3, 128, 10, closed)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
