"""Port parity of the training path's differentiable operations against the
JAX package: safe_eigh (the eigengap-clamped custom VJP), the train-mode
standardize_points, the four primitive fits, the differentiable branch of
guard_mean_shift, the triplet and NLL losses and mean_iou_per_class.

Values and gradients (torch.autograd against jax.grad / jax.vjp, the same
inputs and draws) are held to the tolerance each test states, as a norm of
the difference relative to the norm of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.losses import embedding as jemb
from parsenet_tpu.ops import linalg as jla
from parsenet_tpu.ops import mean_shift as jms
from parsenet_tpu.ops import primitive_fits as jfits
from parsenet_tpu.ops import standardize as jst
from parsenet_tpu.ops.segmentation import mean_iou_per_class as jax_miou
from parsenet_tpu_torch.core.guards import set_fp32_policy
from parsenet_tpu_torch.losses import embedding as temb
from parsenet_tpu_torch.ops import linalg as tla
from parsenet_tpu_torch.ops import mean_shift as tms
from parsenet_tpu_torch.ops import primitive_fits as tfits
from parsenet_tpu_torch.ops import standardize as tst
from parsenet_tpu_torch.ops.segmentation import mean_iou_per_class

torch.set_num_threads(1)
set_fp32_policy()


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _sym(rng, n, gaps):
    """n symmetric 3x3 matrices Q diag(ev) Q^T; gaps: the spectra's
    (lambda_2 - lambda_1, lambda_3 - lambda_2)."""
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        ev = rng.uniform(0.5, 2.0) + np.cumsum([0.0, *gaps])
        out.append(q @ np.diag(ev) @ q.T)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize(
    "gaps", [(0.7, 1.1), (1e-6, 0.8), (0.9, 3e-5)],
    ids=["separated", "near_equal_low", "near_equal_high"])
def test_safe_eigh_forward_and_backward_match_jax(rng, gaps):
    """Eigenvalues and the custom VJP's dA for random cotangents: 1e-5
    relative. Eigenvectors (and the full VJP through them) are compared
    where the spectrum is separated; a pair closer than the clamp has no
    defined basis, so there the backward formulas are held to each other
    on the port's own (w, U)."""
    A = _sym(rng, 16, gaps)
    gw = rng.randn(16, 3).astype(np.float32)
    gU = rng.randn(16, 3, 3).astype(np.float32)
    (jw, jU), vjp = jax.vjp(jla.safe_eigh, jnp.asarray(A))
    At = torch.tensor(A, requires_grad=True)
    tw, tU = tla.safe_eigh(At)
    assert rel(tw.detach(), jw) <= 1e-5
    torch.autograd.backward((tw, tU), (torch.from_numpy(gw),
                                       torch.from_numpy(gU)))
    if gaps[0] > 1e-3 and gaps[1] > 1e-3:
        assert rel(torch.abs(tU.detach()), np.abs(np.asarray(jU))) <= 1e-5
        (dA,) = vjp((jnp.asarray(gw), jnp.asarray(gU)))
        assert rel(At.grad, dA) <= 1e-5
    else:
        (dA,) = jla._safe_eigh_bwd((jnp.asarray(tw.detach().numpy()),
                                    jnp.asarray(tU.detach().numpy())),
                                   (jnp.asarray(gw), jnp.asarray(gU)))
        assert rel(At.grad, dA) <= 1e-5
    assert torch.isfinite(At.grad).all()


def test_safe_eigh_equal_eigenvalues_give_finite_gradients():
    """A multiple of the identity: autograd through the Jacobi rotations
    would divide by zero; the clamped backward stays finite."""
    A = torch.tensor(np.eye(3, dtype=np.float32)[None] * 2.0,
                     requires_grad=True)
    w, U = tla.safe_eigh(A)
    (w.sum() + U.sum()).backward()
    assert torch.isfinite(A.grad).all()


def _segment_data(n=256, k=3, seed=0):
    pts, lab, nrm, _ = make_shape_batch(np.random.RandomState(seed), 1, n,
                                        min_segments=3, max_segments=4)
    w = np.stack([(lab[0] == s).astype(np.float32) for s in range(k)])
    w = w * 0.9 + 0.1 * np.random.RandomState(seed + 1).rand(k, n)
    return pts[0], nrm[0], w.astype(np.float32)


def test_standardize_gradient_matches_jax(rng):
    """train-mode standardize_points: the gradient through the weighted
    mean into the points and weights (rotation and scale detached), 1e-4
    relative; the forward 1e-5."""
    pts, _, w = _segment_data()
    proj = rng.randn(*pts.shape).astype(np.float32)

    def jf(p, ww):
        return jnp.sum(jst.standardize_points(p, ww).points * proj)

    jval, (jgp, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(pts), jnp.asarray(w[0]))
    tp = torch.tensor(pts, requires_grad=True)
    tw = torch.tensor(w[0], requires_grad=True)
    tval = torch.sum(tst.standardize_points(tp, tw).points
                     * torch.from_numpy(proj))
    tval.backward()
    assert rel(float(tval), float(jval)) <= 1e-5
    assert rel(tp.grad, jgp) <= 1e-4
    assert rel(tw.grad, jgw) <= 1e-4


def test_fits_gradients_match_jax(rng):
    """fit_all_primitives_shared_points over 3 soft segments: every
    parameter 1e-4 relative, and the gradient of a random linear read-out
    of all of them with respect to the points, normals and weights, 1e-4
    relative."""
    pts, nrm, w = _segment_data()
    jout = jfits.fit_all_primitives_shared_points(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(w))
    leaves = jax.tree_util.tree_leaves(jout)
    coef = [rng.randn(*np.shape(l)).astype(np.float32) for l in leaves]

    def jf(p, n_, ww):
        out = jfits.fit_all_primitives_shared_points(p, n_, ww)
        return sum(jnp.sum(l * c) for l, c in
                   zip(jax.tree_util.tree_leaves(out), coef))

    jgrads = jax.grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(w))
    ins = [torch.tensor(a, requires_grad=True) for a in (pts, nrm, w)]
    tout = tfits.fit_all_primitives_shared_points(*ins)
    tleaves = [t for group in tout for t in group]
    for t, l in zip(tleaves, leaves):
        assert rel(t.detach(), l) <= 1e-4
    sum(torch.sum(t * torch.from_numpy(c))
        for t, c in zip(tleaves, coef)).backward()
    for t, g in zip(ins, jgrads):
        assert rel(t.grad, g) <= 1e-4


def _embedding(n=256, d=8, seed=2):
    r = np.random.RandomState(seed)
    centers = r.randn(4, d)
    x = centers[r.randint(0, 4, n)] + 0.35 * r.randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("attempt_iterations", [None, 2])
def test_guard_mean_shift_differentiable_matches_jax(rng, attempt_iterations):
    """The training branch: the same subset draw gives the same bandwidth
    and cluster count; the re-run's shifted rows and the gradient of a
    random read-out of them with respect to X within 1e-5 relative."""
    X = _embedding()
    key = jax.random.PRNGKey(3)
    proj = rng.randn(*X.shape).astype(np.float32)

    def jf(x):
        r = jms.guard_mean_shift(x, 0.1, key=key, num_samples=128,
                                 iterations=5,
                                 attempt_iterations=attempt_iterations)
        return jnp.sum(r.shifted * proj), r

    (_, jr), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(X))
    subset = torch.from_numpy(np.asarray(jax.random.permutation(
        key, X.shape[0])))
    tx = torch.tensor(X, requires_grad=True)
    tr = tms.guard_mean_shift(tx, 0.1, num_samples=128, iterations=5,
                              subset=subset, differentiable=True,
                              attempt_iterations=attempt_iterations)
    torch.sum(tr.shifted * torch.from_numpy(proj)).backward()
    assert float(tr.bandwidth) == pytest.approx(float(jr.bandwidth),
                                                rel=1e-6)
    assert tr.num_clusters == int(jr.num_clusters)
    assert rel(tr.shifted.detach(), jr.shifted) <= 1e-5
    assert rel(tx.grad, jg) <= 1e-5
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    with torch.no_grad():   # eval_step's re-run: K1 (its plain version here)
        nr = tms.guard_mean_shift(tx, 0.1, num_samples=128, iterations=5,
                                  subset=subset, differentiable=True,
                                  attempt_iterations=attempt_iterations)
    assert rel(nr.shifted, jr.shifted) <= 1e-5
    assert nr.num_clusters == tr.num_clusters


def _triplet_inputs(b=2, n=300, d=8, seed=4):
    pts, lab, _, _ = make_shape_batch(np.random.RandomState(seed), b, n,
                                      min_segments=2, max_segments=5)
    lab[1] = 0   # a one-segment shape, left out of the batch mean
    emb = np.random.RandomState(seed + 1).randn(b, n, d).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ups, upr = [], []
    for k in jax.random.split(key, b):
        k_pts, k_pairs = jax.random.split(k)
        ups.append(np.asarray(jax.random.uniform(
            k_pts, (jemb.S_MAX, jemb.P_SAMPLES))))
        upr.append(np.asarray(jax.random.uniform(k_pairs,
                                                 (jemb.N_PAIRS, 2))))
    return emb, lab, key, np.stack(ups), np.stack(upr)


def test_triplet_loss_matches_jax():
    """The same draws: the loss within 1e-6 relative, its gradient 1e-5."""
    emb, lab, key, ups, upr = _triplet_inputs()
    jval, jg = jax.value_and_grad(
        lambda e: jemb.triplet_loss(e, jnp.asarray(lab), key))(
            jnp.asarray(emb))
    te = torch.tensor(emb, requires_grad=True)
    tval = temb.triplet_loss(te, torch.from_numpy(lab), torch.from_numpy(ups),
                             torch.from_numpy(upr))
    tval.backward()
    assert float(jval) > 0
    assert rel(float(tval), float(jval)) <= 1e-6
    assert rel(te.grad, jg) <= 1e-5


def test_primitive_nll_and_miou_match_jax(rng):
    """The NLL within 1e-6 relative (gradient 1e-5); mean_iou_per_class
    exactly."""
    logits = rng.randn(2, 200, 10).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    gt = rng.randint(0, 10, (2, 200))
    jval, jg = jax.value_and_grad(
        lambda p: jemb.primitive_nll_loss(p, jnp.asarray(gt)))(
            jnp.asarray(logp))
    tp = torch.tensor(logp, requires_grad=True)
    tval = temb.primitive_nll_loss(tp, torch.from_numpy(gt))
    tval.backward()
    assert rel(float(tval), float(jval)) <= 1e-6
    assert rel(tp.grad, jg) <= 1e-5
    gt[:, :20] = 3   # a class both sides miss on some points
    assert float(mean_iou_per_class(torch.from_numpy(gt),
                                    torch.from_numpy(logits))) == \
        float(jax_miou(jnp.asarray(gt), jnp.asarray(logits)))
