"""Reading the committed flax parameter exports (params/*.npz).

An export is a flat npz whose keys are '/'-joined flax tree paths, for
example "params/encoder/conv1/w_diff/kernel", stored as float16 or float32.
"""
from __future__ import annotations

import numpy as np


def load_npz_params(path: str) -> dict[str, np.ndarray]:
    """Flat {"params/...": float32 ndarray} dict of an npz export."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}
