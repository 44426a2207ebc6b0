"""Port parity: the bf16 network (models.dgcnn dtype / gather_bf16 /
remat) and the trainers' half_precision, which builds it.

* The bf16 PrimitivesEmbedding from the shipped weights, 2 shapes x 1,024
  points of make_shape_batch(RandomState(13)), k 16, against the JAX
  package's bf16 network run op by op (flax apply outside jit, so each bf16
  result is rounded where the program rounds it): first on the JAX
  package's own kNN graphs, then end to end on the port's own graphs.
  XLA on the CPU keeps some bf16 intermediates in f32 inside a jit
  (excess precision), so a jitted JAX bf16 network is not this reference.
* The bf16 kNN graph: the port's on bf16 features equals the JAX
  package's (its f32 products of bf16 values, its bf16-rounded norms).
* remat=True gives the loss and every gradient of remat=False, bit for bit.
* (tests/test_torch_half_precision_steps.py: one half_precision step of
  each trainer against the JAX trainer's bf16 step.) run_training with half_precision on
  tests/test_torch_train_state.py::_tiny_config: parameters stay f32, and
  the step-1 embed_loss moves off the f32 run's 0.9555736780 (the flag was
  once ignored).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import load_npz_params as jax_load_npz
from parsenet_tpu.data.abc import normalize_points
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu.ops import knn as jknn
from parsenet_tpu_torch.core.checkpoint import load_npz_params
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             params_from_jax)
from parsenet_tpu_torch.ops import knn as tknn
from parsenet_tpu_torch.train import train_e2e as te2e
from parsenet_tpu_torch.train import train_seg as tseg
from test_torch_train_state import _tiny_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")
N, K = 1024, 16
BF16 = dict(dtype=torch.bfloat16, gather_bf16=True)


def _shapes(n=N, b=2, seed=13):
    pts, _, nrm, _ = make_shape_batch(np.random.RandomState(seed), b, n)
    for i in range(b):
        pts[i], nrm[i], _, _ = normalize_points(pts[i], nrm[i])
    return np.concatenate([pts, nrm], -1).astype(np.float32)


@pytest.fixture(scope="module")
def bf16_runs():
    """{config: (JAX embedding, JAX log-probs, the JAX package's kNN graphs
    in call order)} for the bf16 network and the f32 one with bf16
    gathers, eager flax apply."""
    x = _shapes()
    out = {}
    for name, dt, gb in (("bf16", jnp.bfloat16, True),
                         ("gather_bf16", jnp.float32, True)):
        graphs = []
        real = (jknn.knn, jknn.knn_points_normals)

        def rec(fn):
            def f(*a, **kw):
                idx = fn(*a, **kw)
                graphs.append(np.asarray(idx))
                return idx
            return f
        jknn.knn, jknn.knn_points_normals = rec(real[0]), rec(real[1])
        try:
            jm = JaxEmbedding(emb_size=128, num_primitives=10, mode=5, k=K,
                              dtype=dt, gather_bf16=gb)
            e, p = jm.apply({"params": jax_load_npz(PARAMS)["params"]},
                            jnp.asarray(x))
        finally:
            jknn.knn, jknn.knn_points_normals = real
        out[name] = (np.asarray(e), np.asarray(p), graphs)
    return x, out


def _port(x, graphs=None, **kw):
    model = PrimitivesEmbedding(mode=5, k=K, **kw)
    model.load_state_dict(params_from_jax(load_npz_params(PARAMS), model))
    real = (tknn.knn, tknn.knn_points_normals)
    if graphs is not None:
        it = iter(graphs)
        tknn.knn = tknn.knn_points_normals = \
            lambda *a, **k: torch.from_numpy(next(it))
    try:
        with torch.no_grad():
            e, p = model(torch.from_numpy(x))
    finally:
        tknn.knn, tknn.knn_points_normals = real
    assert e.dtype == p.dtype == torch.float32
    return e.numpy(), p.numpy()


# Measured on the JAX package's graphs (bf16): the embedding within 4.5e-3
# of its largest magnitude and bit-equal in most entries (bf16's 2^-8 =
# 3.9e-3 relative), 99.8% of the type argmaxes equal; with bf16 gathers
# alone (f32 network) 1e-4. Held at twice that.
ON_GRAPHS = {"bf16": (1e-2, 0.99), "gather_bf16": (2e-4, 1.0)}


@pytest.mark.parametrize("config", sorted(ON_GRAPHS))
def test_bf16_network_on_jax_graphs(bf16_runs, config):
    x, runs = bf16_runs
    ref_e, ref_p, graphs = runs[config]
    kw = BF16 if config == "bf16" else dict(gather_bf16=True)
    e, p = _port(x, graphs, **kw)
    scale = np.abs(ref_e).max()
    err = np.abs(e - ref_e).max() / scale
    agree = (p.argmax(-1) == ref_p.argmax(-1)).mean()
    print(f"{config}: max |d| / max |ref| {err:.3e}, median relative "
          f"{np.median(np.abs(e - ref_e) / (np.abs(ref_e) + 1e-3 * scale)):.3e}"
          f", type argmax agreement {agree:.5f}")
    tol, min_agree = ON_GRAPHS[config]
    assert err <= tol
    assert agree >= min_agree


def test_bf16_network_end_to_end(bf16_runs):
    """On the port's own graphs a neighbour tie that bf16 rounding decides
    otherwise moves a point's features, and the global max pool carries it
    to every point: measured 4.6e-2 of the largest magnitude at most, the
    unit embeddings within 1.2e-2 on average, 99.6% of the type argmaxes
    equal. Held to 0.1, 2.5e-2 and 0.99."""
    x, runs = bf16_runs
    ref_e, ref_p, _ = runs["bf16"]
    e, p = _port(x, **BF16)
    unit = lambda v: v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
    err = np.abs(e - ref_e).max() / np.abs(ref_e).max()
    unit_err = np.abs(unit(e) - unit(ref_e)).mean()
    agree = (p.argmax(-1) == ref_p.argmax(-1)).mean()
    print(f"end to end: max |d| / max |ref| {err:.3e}, unit embeddings mean "
          f"|d| {unit_err:.3e}, type argmax agreement {agree:.5f}")
    assert err <= 0.1 and unit_err <= 2.5e-2 and agree >= 0.99


def test_bf16_knn_graph_equals_jax():
    """bf16 features of a post-LeakyReLU layer's kind: the same neighbour
    sets as the JAX package's graph (a bf16 product would differ in about
    a fifth of the rows)."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(np.maximum(rng.randn(2, N, 64), 0) * 2.0).astype(
        jnp.bfloat16)
    ref = np.asarray(jknn.knn(x, k1=K, k2=K, exact=True))
    got = tknn.knn(torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                   .to(torch.bfloat16), k1=K, k2=K).numpy()
    assert [set(r) for r in got.reshape(-1, K)] == \
        [set(r) for r in ref.reshape(-1, K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_remat_matches_no_remat(dtype):
    x = torch.from_numpy(_shapes(256, b=1, seed=3))
    lab = torch.from_numpy(make_shape_batch(np.random.RandomState(3), 1,
                                            256)[1]).long()
    grads, losses = [], []
    for remat in (False, True):
        torch.manual_seed(0)
        model = PrimitivesEmbedding(emb_size=16, mode=5, k=4, dtype=dtype,
                                    gather_bf16=dtype == torch.bfloat16,
                                    remat=remat)
        e, p = model(x)
        loss = (e ** 2).mean() + torch.nn.functional.nll_loss(
            p.reshape(-1, 10), lab.reshape(-1) % 10)
        loss.backward()
        losses.append(loss.detach())
        grads.append({n: q.grad.clone() for n, q in model.named_parameters()})
    assert torch.equal(losses[0], losses[1])
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


F32_EMBED_LOSS = 0.9555736780   # train_seg's step 1 in f32 on _tiny_config


@pytest.mark.parametrize("trainer", ["seg", "e2e"])
def test_half_precision_trains_a_bf16_network(tmp_path, trainer):
    cfg = _tiny_config(tmp_path, model_path=trainer, lr=1e-3)
    mod = tseg if trainer == "seg" else te2e
    kw = dict(steps_per_epoch=1, points_per_shape=256, checkpoint=False,
              device="cpu", val_shapes=2 if trainer == "seg" else 1)
    f32 = mod.run_training(cfg, **kw)
    hp = mod.run_training(cfg.replace(half_precision=True), **kw)
    if trainer == "seg":
        assert f"{f32.steps[0]['embed_loss']:.10f}" == f"{F32_EMBED_LOSS:.10f}"
    assert hp.model.dtype == torch.bfloat16
    assert all(q.dtype == torch.float32 for q in hp.model.parameters())
    assert hp.steps[0]["grad_ok"] == 1.0
    assert all(np.isfinite(v) for v in hp.steps[0].values())
    assert hp.steps[0]["embed_loss"] != f32.steps[0]["embed_loss"]
