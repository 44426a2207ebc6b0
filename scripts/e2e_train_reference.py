"""Metrics of two e2e train steps and two segmentation train steps in the
JAX package, on the CPU: the reference values that the PyTorch port's
chip_smoke.py holds its trainers' parity steps against.

    python scripts/e2e_train_reference.py     # runs on the CPU, a few minutes

Both start from the shipped params/parsenet_e2e.npz (PrimitivesEmbedding
mode 5, k 80, embedding 128); the e2e loss decodes with the shipped
params/{open,closed}_splinenet.npz. Sizes, seeds and draws are
chip_smoke.py's E2E_PARITY and SEG_PARITY:

* e2e: train_e2e.make_e2e_step (quantile 0.025, 5 iterations, lamb 0.1,
  num_accum 1) on make_shape_batch(RandomState(seed), 1, 2048), mean-
  centred, at lr 1e-4;
* seg: train_seg.make_step_fns (num_accum 2) on make_shape_batch(
  RandomState(seed), 4, 1024) as 2 micro-batches of 2, mean-centred, at
  lr 0.01.

The random draws (the triplet loss's point and pair uniforms) are numpy's,
chip_smoke.parity_draws(seed): they are handed to the JAX package in place
of its jax.random.uniform draws of those shapes, so that chip_smoke.py
makes the same ones without JAX. Every shape of a step takes the same
draws, and both steps take them again. No shape here has more points than
the mean-shift subset (2,048), so no subset is drawn.

Prints one JSON object {"e2e": [{...}, {...}], "seg": [...], "seconds": s}:
each step's metrics, taken before its update, so the second step's follow
the first step's gradients and Adam update.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import chip_smoke
from parsenet_tpu.core.checkpoint import load_npz_params
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.losses.embedding import N_PAIRS, P_SAMPLES, S_MAX
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding
from parsenet_tpu.train.state import create_state
from parsenet_tpu.train.train_e2e import build_spline_fit, make_e2e_step
from parsenet_tpu.train.train_seg import make_step_fns


def use_draws(u_points, u_pairs):
    """Route jax.random.uniform's draws of the triplet loss's shapes to
    the given arrays."""
    uniform = jax.random.uniform

    def patched(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if tuple(shape) == (S_MAX, P_SAMPLES):
            return jnp.asarray(u_points)
        if tuple(shape) == (N_PAIRS, 2):
            return jnp.asarray(u_pairs)
        return uniform(key, shape, dtype, minval, maxval)

    jax.random.uniform = patched


def _batch(cfg):
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(cfg["seed"]), cfg["shapes"], cfg["points"])
    pts = pts - pts.mean(1, keepdims=True)
    x = np.concatenate([pts, normals], -1).astype(np.float32)
    return x, labels, prim


def _state(model, n):
    state = create_state(model, jax.random.PRNGKey(0),
                         (jnp.zeros((1, n, 6)),))
    tree = load_npz_params(os.path.join(REPO, "params", "parsenet_e2e.npz"))
    return state.replace(params=tree["params"])


def e2e_reference() -> list:
    cfg = chip_smoke.E2E_PARITY
    use_draws(*chip_smoke.parity_draws(cfg["seed"])[:2])
    x, labels, prim = _batch(cfg)
    model = PrimitivesEmbedding(emb_size=128, num_primitives=10, mode=5,
                                k=cfg["k"])
    state = _state(model, cfg["points"])
    step, _ = make_e2e_step(model, build_spline_fit(20), lamb=0.1)
    steps = []
    for _ in range(2):
        state, m = step(state, jnp.asarray(x), jnp.asarray(labels),
                        jnp.asarray(prim), jax.random.PRNGKey(0),
                        jnp.float32(cfg["lr"]))
        steps.append({k: float(v) for k, v in m.items()})
    return steps


def seg_reference() -> list:
    cfg = chip_smoke.SEG_PARITY
    use_draws(*chip_smoke.parity_draws(cfg["seed"])[:2])
    x, labels, prim = _batch(cfg)
    a = cfg["accum"]
    shape = (a, cfg["shapes"] // a)
    model = PrimitivesEmbedding(emb_size=128, num_primitives=10, mode=5,
                                k=cfg["k"])
    state = _state(model, cfg["points"])
    step, _ = make_step_fns(model, a)
    steps = []
    for _ in range(2):
        state, m = step(state, jnp.asarray(x.reshape(*shape, *x.shape[1:])),
                        jnp.asarray(labels.reshape(*shape, -1)),
                        jnp.asarray(prim.reshape(*shape, -1)),
                        jax.random.PRNGKey(0), jnp.float32(cfg["lr"]))
        steps.append({k: float(v) for k, v in m.items()})
    return steps


if __name__ == "__main__":
    t0 = time.time()
    out = {"e2e": e2e_reference(), "seg": seg_reference()}
    out["seconds"] = time.time() - t0
    print(json.dumps(out))
