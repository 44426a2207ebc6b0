"""Port parity: synthetic shapes and eval canonicalisation (numpy copies)."""
import numpy as np
import pytest
import torch

from parsenet_tpu.data.abc import normalize_points as jax_normalize
from parsenet_tpu.data.synthetic import make_shape_batch as jax_batch
from parsenet_tpu_torch.data.abc import normalize_points
from parsenet_tpu_torch.data.synthetic import make_shape_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [7, 1013])
def test_make_shape_batch_bitwise(seed):
    ref = jax_batch(np.random.RandomState(seed), 2, 1024)
    got = make_shape_batch(np.random.RandomState(seed), 2, 1024)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("anisotropic", [False, True])
def test_normalize_points_bitwise(anisotropic):
    pts, _, nrm, _ = jax_batch(np.random.RandomState(7), 2, 1024)
    for i in range(2):
        ref = jax_normalize(pts[i], nrm[i], anisotropic)
        got = normalize_points(pts[i], nrm[i], anisotropic)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
