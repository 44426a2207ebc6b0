"""The port's bench at reduced scale (tests/test_torch_bench_arms.py's
settings: 256 points, batch 2, 1 timed batch, 1 spline slot a shape) for
the arms that stub a stage and so draw otherwise than the full path: recon
(no reconstruction: residual, p_cov and sk_2 0), ms (GT segments: seg_iou
1), splines (no spline slots) and preprocess (with-replacement slots).
"""
import pytest

from test_torch_bench_arms import check_arm, runs  # noqa: F401 (fixture)

ARMS = {
    "recon": (("residual", "p_cov", "sk_2"), (), ()),
    "ms": ((), ("seg_iou",), ()),
    "splines": ((), (), ()),
    "preprocess": ((), (), ()),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_stub_arm_reduced_run(runs, arm):  # noqa: F811
    check_arm(runs(arm), None, *ARMS[arm])
