"""Metrics of one SplineNet train step in the JAX package, from the shipped
weights on a fixed synthetic batch: the reference values that the PyTorch
port's chip_smoke.py holds its own train step against.

    python scripts/spline_train_reference.py     # runs on the CPU

For mode 0 (open) and mode 1 (closed): params/{open,closed}_splinenet.npz
loaded into SplineNet(grid 20, k 10); the batch is make_spline_batch(
RandomState(seed), 36, 700, grid 20, closed) with seed 0 (open) or 1
(closed), mean-centred and scaled per axis (anisotropic) as the training
data is, without the PCA alignment (the sign of a LAPACK eigenvector, which
the alignment's rotation follows, differs between builds) and without
augmentation; two train_steps on that batch at lr 1e-3, loss_weight 0.9.
Prints one JSON object {"open": [{...}, {...}], "closed": [...]}: each
step's loss, cd, l_reg and lap, taken before its update, so the second
step's follow the first step's gradients, Adam update and BatchNorm
statistics.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from parsenet_tpu.core.checkpoint import load_npz_params
from parsenet_tpu.data.splines import SplineDataset
from parsenet_tpu.data.synthetic import make_spline_batch
from parsenet_tpu.models.splinenet import SplineNet
from parsenet_tpu.ops.bspline import uniform_knot_bspline
from parsenet_tpu.train.state import create_state
from parsenet_tpu.train.train_spline import make_train_step

GRID, BATCH, POINTS = 20, 36, 700
SEEDS = {"open": 0, "closed": 1}


def reference(name: str) -> list:
    closed = name == "closed"
    pts, cps = make_spline_batch(np.random.RandomState(SEEDS[name]), BATCH,
                                 POINTS, GRID, closed)
    # SplineDataset._canon_batch uses its instance only for augmentation
    pts, cps, scales, _ = SplineDataset._canon_batch(None, pts, cps, False,
                                                     True, False)
    model = SplineNet(grid=GRID, k=10, mode=1 if closed else 0)
    state = create_state(model, jax.random.PRNGKey(0),
                         (jnp.zeros((BATCH, POINTS, 3)),), train=True)
    tree = load_npz_params(os.path.join(REPO, "params",
                                        f"{name}_splinenet.npz"))
    state = state.replace(params=tree["params"],
                          batch_stats=tree["batch_stats"])
    nu, nv = uniform_knot_bspline(GRID, GRID, 3, 3, 40)
    train_step, _ = make_train_step(model, jnp.asarray(nu), jnp.asarray(nv),
                                    GRID, closed, anisotropic=True)
    steps = []
    for _ in range(2):
        state, metrics = train_step(state, jnp.asarray(pts), jnp.asarray(cps),
                                    jnp.asarray(scales), jnp.float32(1e-3),
                                    jnp.float32(0.9))
        steps.append({k: float(v) for k, v in metrics.items()})
    return steps


if __name__ == "__main__":
    print(json.dumps({name: reference(name) for name in SEEDS}))
