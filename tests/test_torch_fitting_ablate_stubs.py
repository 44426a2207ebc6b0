"""Port parity: the fits (zero geometric residuals) and siou (no metric)
arms of fitting/pipeline.fitting_loss_shape against the JAX package's, as
tests/test_torch_fitting_ablate.py holds the ms and match arms (its
fixture, tolerances and checks).
"""
import pytest

from test_torch_fitting_ablate import check_arm, setup  # noqa: F401


@pytest.mark.parametrize("arm", ["fits", "siou"])
def test_fitting_loss_stub_arm_matches_jax(setup, arm):  # noqa: F811
    check_arm(setup, arm)
