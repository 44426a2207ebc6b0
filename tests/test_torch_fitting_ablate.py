"""Port parity: the stage-costing arms of the differentiable fitting loss
(fitting/pipeline.fitting_loss_shape(ablate=...)) against the JAX
package's, on tests/test_torch_fitting_loss.py's shape, embeddings,
decoders and mean-shift subset: ms (GT-segment centres), match (identity
columns), fits (zero geometric residuals) and siou (no metric).

Each returned value within 1e-4 relative (1e-6 absolute where the JAX
value is 0), num_clusters exactly; the gradient with respect to the
embedding by cosine >= 0.999 and relative L2 <= 1e-3, the tolerances of
the default graph's test. The ms arm's gradient is finite although most
of the 50 GT segments are empty (a zero centre row, normalised by
sqrt(sum + 1e-12)).

The ms arm runs on weaker embeddings (WEAK): with the GT segments' own
mean embeddings as centres, the fixture's embeddings saturate every
membership softmax (bandwidth 0.1: exp(50 cos)), where the gradient is f32
round-off; there the JAX package's gradient of weights_normalize even
overflows (norm 763 against float64's 3.6e-6 and the port's 5.7e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.fitting import pipeline as jfp
from parsenet_tpu_torch.core.guards import set_fp32_policy
from parsenet_tpu_torch.fitting import pipeline as tfp
from test_torch_fitting_loss import N, setup  # noqa: F401 (fixture)

torch.set_num_threads(1)
set_fp32_policy()

RTOL = 1e-4


def weak_embedding(lab):
    """Unit-variance noise with a 0.3 pull towards each GT segment's axis:
    memberships far from saturation."""
    return (np.random.RandomState(2).randn(N, 16)
            + 0.3 * np.eye(16)[lab % 16]).astype(np.float32)


@pytest.mark.parametrize("arm", ["ms", "match"])
def test_fitting_loss_arm_matches_jax(setup, arm):  # noqa: F811
    check_arm(setup, arm)


def check_arm(setup, arm):  # noqa: F811
    jfit, tfit, (pts, nrm, lab, prim), emb = setup
    if arm == "ms":
        emb = weak_embedding(lab)
    key = jax.random.PRNGKey(5)

    def jf(e, p, n_, l_, pr):
        out = jfp.fitting_loss_shape(p, n_, e, l_, pr, key, spline_fit=jfit,
                                     ms_num_samples=256, ablate=(arm,))
        return out.loss, out

    (_, ref), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        *(jnp.asarray(a) for a in (emb, pts, nrm, lab, prim)))
    subset = torch.from_numpy(np.asarray(jax.random.permutation(key, N)))
    te = torch.tensor(emb, requires_grad=True)
    out = tfp.fitting_loss_shape(
        torch.from_numpy(pts), torch.from_numpy(nrm), te,
        torch.from_numpy(lab), torch.from_numpy(prim), subset=subset,
        spline_fit=tfit, ms_num_samples=256, ablate=(arm,))
    out.loss.backward()
    for k in ("loss", "geom_loss", "spline_loss", "seg_iou", "prim_iou"):
        got, want = float(getattr(out, k)), float(getattr(ref, k))
        print(f"{arm} {k}: port {got:.7g} JAX {want:.7g}")
        assert abs(got - want) <= max(RTOL * abs(want), 1e-6), (k, got, want)
    assert out.num_clusters == int(ref.num_clusters)
    if arm == "fits":
        assert float(out.geom_loss) == 0.0
    if arm == "siou":
        assert float(out.seg_iou) == float(out.prim_iou) == 0.0
    g, r = te.grad.numpy().astype(np.float64), np.asarray(jg, np.float64)
    assert np.isfinite(g).all()
    print(f"{arm} gradient norms: port {np.linalg.norm(g):.4g} JAX "
          f"{np.linalg.norm(r):.4g}, max |d| {np.abs(g - r).max():.4g}")
    cos = float(g.ravel() @ r.ravel()
                / (np.linalg.norm(g) * np.linalg.norm(r)))
    assert cos >= 0.999, cos
    assert np.linalg.norm(g - r) / np.linalg.norm(r) <= 1e-3


def test_ms_arm_gradient_finite_with_an_empty_segment(setup):  # noqa: F811
    """GT segment 1 emptied (its points relabelled 0): the centre rows of
    the empty segments stay finite, and so does the gradient."""
    _, tfit, (pts, nrm, lab, prim), emb = setup
    lab = np.where(lab == 1, 0, lab)
    te = torch.tensor(emb, requires_grad=True)
    out = tfp.fitting_loss_shape(
        torch.from_numpy(pts), torch.from_numpy(nrm), te,
        torch.from_numpy(lab), torch.from_numpy(prim), spline_fit=tfit,
        ablate=("ms",))
    out.loss.backward()
    assert np.isfinite(float(out.loss))
    assert torch.isfinite(te.grad).all() and float(te.grad.abs().sum()) > 0


def test_unknown_arm_raises():
    with pytest.raises(ValueError, match="ablate"):
        tfp.fitting_loss_shape(torch.zeros(8, 3), torch.zeros(8, 3),
                               torch.zeros(8, 4),
                               torch.zeros(8, dtype=torch.int64),
                               torch.zeros(8, dtype=torch.int64),
                               ablate=("splines",))
