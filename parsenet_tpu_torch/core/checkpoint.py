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


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict of arrays -> flat {'a/b/c': array} dict."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_npz_params(path: str, flat: dict[str, np.ndarray]) -> None:
    """Write a flat export (f32) atomically: a reader never sees half a
    file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    os.replace(tmp, path)


def _state_path(npz_path: str) -> str:
    return os.path.splitext(npz_path)[0] + ".train_state.pt"


def save_train_state(npz_path: str, flat: dict[str, np.ndarray],
                     optimizer_state: dict, step: int) -> None:
    """The weights as an npz export at `npz_path`, and beside it the
    optimizer's state_dict and the step (torch.save), each written
    atomically."""
    import torch
    save_npz_params(npz_path, flat)
    path = _state_path(npz_path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"optimizer": optimizer_state, "step": int(step)}, tmp)
    os.replace(tmp, path)


def load_train_state(npz_path: str):
    """(flat weights, optimizer state_dict, step) saved by
    `save_train_state`, or None when either file is absent."""
    import torch
    path = _state_path(npz_path)
    if not (os.path.exists(npz_path) and os.path.exists(path)):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    return load_npz_params(npz_path), state["optimizer"], state["step"]


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (torch semantics, mode=min): when the
    metric has not improved by more than eps for more than `patience`
    epochs, the lr is scaled by `factor`, down to min_lr (reference:
    train_parsenet.py:137-140)."""

    def __init__(self, lr: float, patience: int = 8, factor: float = 0.5,
                 min_lr: float = 1e-7, eps: float = 1e-8):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.eps = eps
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best - self.eps:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
