"""Flax parameter exports (params/*.npz), the tree helpers and the
plateau lr schedule.

An export is a flat npz whose keys are '/'-joined flax tree paths, for
example "params/encoder/conv1/w_diff/kernel", stored as float16 or float32.
The trainers save their best-validation weights in the same layout (f32),
which parsenet_tpu.core.checkpoint.load_npz_params reads back; the JAX
package's orbax checkpoints are not ported. For a resumed run (the
segmentation trainer's preload_model) the optimizer state and the step are
saved beside the npz with torch.save (`save_train_state`).
"""
from __future__ import annotations

import os

import numpy as np


def load_npz_params(path: str) -> dict[str, np.ndarray]:
    """Flat {"params/...": float32 ndarray} dict of an npz export."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}
