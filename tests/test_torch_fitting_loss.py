"""Port parity: the differentiable fitting loss of one shape
(fitting/pipeline.fitting_loss_shape) against the JAX package's, on fixed
embeddings: one shape of 512 points (make_shape_batch(RandomState(0), 1,
512, min_segments=2, max_segments=4)), embeddings clustered by segment,
the same mean-shift subset draw, decoders at grid 10 / sample grid 8
carried from the JAX package's initialisation; the default graph and
FAST_STEP_KNOBS.

Each returned value within 1e-4 relative, num_clusters exactly; the
gradient with respect to the embedding by cosine >= 0.999 and relative L2
<= 1e-3. Also the pieces the loss is built from: weights_normalize,
cluster_centers and gt_segment_prim_votes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import flatten_tree
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.fitting import pipeline as jfp
from parsenet_tpu.models.splinenet import SplineNet as JaxSplineNet
from parsenet_tpu.ops.mean_shift import MeanShiftResult as JaxMS
from parsenet_tpu.train.train_e2e import FAST_STEP_KNOBS
from parsenet_tpu.train.train_e2e import build_spline_fit as jax_spline_fit
from parsenet_tpu_torch.core.guards import set_fp32_policy
from parsenet_tpu_torch.fitting import pipeline as tfp
from parsenet_tpu_torch.fitting.spline_apply import SplineFit
from parsenet_tpu_torch.models import splinenet as tsn
from parsenet_tpu_torch.ops.mean_shift import MeanShiftResult

torch.set_num_threads(1)
set_fp32_policy()

N = 512
RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    rng = jax.random.PRNGKey(0)
    variables = [JaxSplineNet(grid=10, k=10, mode=m).init(
        rng, jnp.zeros((1, 128, 3)), train=False) for m in (0, 1)]
    jfit = jax_spline_fit(grid=10, sample_grid=8, open_vars=variables[0],
                          closed_vars=variables[1])
    models = []
    for mode, v in enumerate(variables):
        m = tsn.SplineNet(grid=10, k=10, mode=mode)
        m.load_state_dict(tsn.params_from_jax(
            {k: np.asarray(a) for k, a in flatten_tree(v).items()}, m))
        models.append(m)
    pts, lab, nrm, prim = make_shape_batch(np.random.RandomState(0), 1, N,
                                           min_segments=2, max_segments=4)
    emb = (0.3 * np.random.RandomState(1).randn(N, 16)
           + 2.0 * np.eye(16)[lab[0] % 16]).astype(np.float32)
    return jfit, SplineFit(*models, sample_grid=8), (pts[0], nrm[0], lab[0],
                                                     prim[0]), emb


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast_step"])
def test_fitting_loss_matches_jax(setup, fast):
    jfit, tfit, (pts, nrm, lab, prim), emb = setup
    knobs = dict(FAST_STEP_KNOBS) if fast else {}
    key = jax.random.PRNGKey(5)

    def jf(e, p, n_, l_, pr):
        out = jfp.fitting_loss_shape(p, n_, e, l_, pr, key, spline_fit=jfit,
                                     ms_num_samples=256, **knobs)
        return out.loss, out

    (_, ref), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        *(jnp.asarray(a) for a in (emb, pts, nrm, lab, prim)))
    subset = torch.from_numpy(np.asarray(jax.random.permutation(key, N)))
    te = torch.tensor(emb, requires_grad=True)
    out = tfp.fitting_loss_shape(
        torch.from_numpy(pts), torch.from_numpy(nrm), te,
        torch.from_numpy(lab), torch.from_numpy(prim), subset=subset,
        spline_fit=tfit, ms_num_samples=256, **knobs)
    out.loss.backward()
    assert float(ref.spline_loss) > 0 and float(ref.geom_loss) > 0
    for k in ("loss", "geom_loss", "spline_loss", "seg_iou", "prim_iou"):
        got, want = float(getattr(out, k)), float(getattr(ref, k))
        assert abs(got - want) <= RTOL * abs(want), (k, got, want)
    assert out.num_clusters == int(ref.num_clusters)
    g, r = te.grad.numpy().astype(np.float64), np.asarray(jg, np.float64)
    cos = float(g.ravel() @ r.ravel()
                / (np.linalg.norm(g) * np.linalg.norm(r)))
    assert cos >= 0.999, cos
    assert np.linalg.norm(g - r) / np.linalg.norm(r) <= 1e-3


def test_weights_normalize_matches_jax(rng):
    """Values 1e-6 relative, the gradient 1e-5, with a tie in a row's
    minimum (amin splits the gradient as jnp.min does)."""
    w = rng.randn(6, 40).astype(np.float32)
    w[:, 3] = w[:, 4] = -5.0
    valid = np.array([1, 1, 0, 1, 1, 0], bool)
    proj = rng.randn(6, 40).astype(np.float32)
    bw = np.float32(0.4)
    jval, jg = jax.value_and_grad(
        lambda x: jnp.sum(jfp.weights_normalize(x, bw, jnp.asarray(valid))
                          * proj))(jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    tval = torch.sum(tfp.weights_normalize(tw, torch.tensor(bw),
                                           torch.from_numpy(valid))
                     * torch.from_numpy(proj))
    tval.backward()
    assert abs(float(tval) - float(jval)) <= 1e-6 * abs(float(jval))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def test_cluster_centers_and_votes_match_jax(rng):
    """cluster_centers (centres in point-index order) and the GT type
    votes: exactly."""
    n, d = 120, 8
    shifted = rng.randn(n, d).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[[7, 30, 31, 99]] = 1.0
    labels = rng.randint(0, 4, n)
    jms = JaxMS(jnp.asarray(shifted), jnp.asarray(mask), jnp.asarray(labels),
                jnp.float32(0.1), jnp.int32(4))
    tms = MeanShiftResult(torch.from_numpy(shifted), torch.from_numpy(mask),
                          torch.from_numpy(labels), torch.tensor(0.1), 4)
    emb = jnp.asarray(shifted)
    jc, jv = jfp.cluster_centers(jms, emb)
    tc, tv = tfp.cluster_centers(tms, torch.from_numpy(shifted))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    gt = rng.randint(0, 12, n)
    pr = rng.randint(0, 10, n)
    np.testing.assert_array_equal(
        tfp.gt_segment_prim_votes(torch.from_numpy(gt),
                                  torch.from_numpy(pr)).numpy(),
        np.asarray(jfp.gt_segment_prim_votes(jnp.asarray(gt),
                                             jnp.asarray(pr))))
