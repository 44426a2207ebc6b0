"""The frozen spline decoders of the inference path and of the e2e loss.

Counterpart of make_spline_apply(...).batched and .batched_eval
(parsenet_tpu/fitting/pipeline.py:126-167) and of build_spline_fit
(parsenet_tpu/train/train_e2e.py:56-97): the open and closed SplineNets
(k = 10, grid 20) in eval mode with their parameters frozen, and the basis
matrices of their 30 x 30 parameter grids. Each slot's points are
standardised, decoded to a control grid (closed: with its wrap-around row),
sampled on the grid and carried back to the segment's frame (reference
src/primitive_forward.py:34-85, 347-397). `batched_eval` takes the
preprocessed points of the inference path with unit weights, without
gradient; `batched` takes the whole strided cloud with each slot's soft
weights, and gradients flow through both into the embedding (reference
residual_utils.py:50-66 freezes the pretrained decoders the same way).

`build_spline_fit` reads {open,closed}_splinenet.npz of a directory (the
committed params/ by default; `trained_spline_fit` takes a run's own
checkpoints where both exist). A missing or unreadable file raises: the
JAX package falls back to randomly initialised decoders there, the port
does not.
"""
from __future__ import annotations

import os

import torch
import torch.nn as nn

from ..models.splinenet import SplineNet, load_splinenet
from ..ops.bspline import (close_control_grid, sample_surface,
                           uniform_knot_bspline)
from ..ops.standardize import standardize_points, unstandardize_points

PARAMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "params")
OPEN_PTS = 1500    # open decoders read the first 1,500 preprocessed rows
CLOSED_PTS = 1800  # closed ones all 1,800 (primitive_forward.py:996, 1035)


class SplineFit(nn.Module):
    """Open and closed SplineNets with the basis matrices of their sample
    grids: uniform_knot_bspline(grid, grid, 3, 3, sample_grid) for the open
    control grid, (grid + 1, grid, ...) for the closed one."""

    def __init__(self, open_model: SplineNet, closed_model: SplineNet,
                 sample_grid: int = 30):
        super().__init__()
        self.open_model = open_model.eval().requires_grad_(False)
        self.closed_model = closed_model.eval().requires_grad_(False)
        grid = open_model.grid
        dev = next(open_model.parameters()).device
        for name, (u, v) in (
                ("", uniform_knot_bspline(grid, grid, 3, 3, sample_grid)),
                ("_c", uniform_knot_bspline(grid + 1, grid, 3, 3,
                                            sample_grid))):
            self.register_buffer("nu" + name, torch.from_numpy(u).to(dev))
            self.register_buffer("nv" + name, torch.from_numpy(v).to(dev))

    def _decode(self, model: SplineNet, pts: torch.Tensor, closed: bool,
                w=None):
        if w is None:
            w = torch.ones(pts.shape[:2], dtype=pts.dtype, device=pts.device)
        st = standardize_points(pts, w)
        cp = model(st.points, weights=w).reshape(
            pts.shape[0], model.grid, model.grid, 3)
        if closed:
            surf = sample_surface(self.nu_c, self.nv_c, close_control_grid(cp))
        else:
            surf = sample_surface(self.nu, self.nv, cp)
        return unstandardize_points(surf, st)

    def batched(self, points: torch.Tensor, weights: torch.Tensor,
                is_closed: torch.Tensor) -> torch.Tensor:
        """points [S, M, 3], soft weights [S, M], is_closed [S] bool ->
        surfaces [S, sample_grid^2, 3]: every slot through both decoders,
        the closed one's surface where is_closed; differentiable in points
        and weights."""
        surf_o = self._decode(self.open_model, points, False, weights)
        surf_c = self._decode(self.closed_model, points, True, weights)
        return torch.where(is_closed[:, None, None], surf_c, surf_o)

    @torch.no_grad()
    def batched_eval(self, pts1800: torch.Tensor,
                     is_closed: torch.Tensor) -> torch.Tensor:
        """pts1800 [S, 1800, 3] preprocessed segment points, is_closed [S]
        bool -> surfaces [S, sample_grid^2, 3]: every slot through both
        decoders (open on its first 1,500 rows, closed on all 1,800; weights
        all ones), the closed one's surface where is_closed."""
        surf_o = self._decode(self.open_model, pts1800[:, :OPEN_PTS], False)
        surf_c = self._decode(self.closed_model, pts1800, True)
        return torch.where(is_closed[:, None, None], surf_c, surf_o)


def build_spline_fit(grid: int = 20, sample_grid: int = 30,
                     params_dir: str = PARAMS_DIR, device=None) -> SplineFit:
    """The decoders of {params_dir}/{open,closed}_splinenet.npz on `device`
    (None = "cuda"). Raises when either file is missing or does not fit."""
    return SplineFit(
        load_splinenet(os.path.join(params_dir, "open_splinenet.npz"), 0,
                       grid, device=device),
        load_splinenet(os.path.join(params_dir, "closed_splinenet.npz"), 1,
                       grid, device=device),
        sample_grid)


def trained_spline_fit(log_dir: str, grid: int = 20,
                       device=None) -> SplineFit:
    """The decoders of {log_dir}/checkpoints/{open,closed}_splinenet.npz
    (the port's SplineNet trainer saves them there) where both exist, else
    those of the committed params/."""
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    own = all(os.path.exists(os.path.join(ckpt_dir, f"{n}_splinenet.npz"))
              for n in ("open", "closed"))
    return build_spline_fit(grid, params_dir=ckpt_dir if own else PARAMS_DIR,
                            device=device)
