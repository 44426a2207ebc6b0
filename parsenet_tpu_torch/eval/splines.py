"""SplineNet evaluation (open & closed).

Counterpart of parsenet_tpu/eval/splines.py (reference test_open_splines.py
/ test_closed_control_points.py): load a trained decoder, run the test
split, report the two-sided sqrt chamfer between the predicted surfaces and
the input points (K3 both ways on the card), optionally run the classical
post-optimization refit (postprocess.optimize_spline_kronecker, on the
host), and export gt/pred meshes as PLY.
"""
from __future__ import annotations

import logging
import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.guards import entry_device
from ..models.splinenet import SplineNet, load_splinenet
from ..ops.bspline import (close_control_grid, sample_surface,
                           uniform_knot_bspline)
from ..ops.chamfer import chamfer_distance
from ..postprocess import optimize_spline_kronecker, tessellate_grid, write_ply
from ..train.train_spline import rescale_outputs

log = logging.getLogger(__name__)
SAMPLE_GRID = 40   # the 40 x 40 parameter grid of both decoders' surfaces


def load_checkpoint(config: Config, closed: bool, device=None) -> SplineNet:
    """The SplineNet the trainer saved at {log_dir}/checkpoints/
    {model_path}.npz; a missing file raises (no random decoder)."""
    path = os.path.join(config.log_dir, "checkpoints",
                        f"{config.model_path}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no SplineNet checkpoint at {path}: train one first "
            "(python -m parsenet_tpu_torch.cli.train_"
            f"{'closed_control_points' if closed else 'open_splines'})")
    return load_splinenet(path, int(closed), config.grid_size,
                          device=device)


def _refit_chamfer(refined: np.ndarray, inp: np.ndarray) -> float:
    d1 = np.sqrt(((refined[:, None] - inp[None]) ** 2).sum(-1).min(1)).mean()
    d2 = np.sqrt(((inp[:, None] - refined[None]) ** 2).sum(-1).min(1)).mean()
    return float(0.5 * (d1 + d2))


@torch.no_grad()
def evaluate_splinenet(config: Config, closed: bool = False,
                       test_gen: Optional[Iterator] = None,
                       num_batches: Optional[int] = None,
                       model: Optional[SplineNet] = None,
                       if_optimize: bool = False,
                       export_dir: Optional[str] = None,
                       anisotropic: bool = True, device=None) -> dict:
    """Returns {'cd': mean two-sided sqrt chamfer, 'cd_optim': the same
    after the refit (with if_optimize)}. model: the decoder, else
    load_checkpoint(config); test_gen: batches (points, control points,
    scales, rotations), else the config's h5 test split. device None =
    "cuda"."""
    from ..data.splines import SplineDataset

    dev = entry_device(device)
    grid = config.grid_size
    if model is None:
        model = load_checkpoint(config, closed, dev)
    model.eval()
    if test_gen is None:
        default_tr, default_val = (28000, 3000) if closed else (50000, 10000)
        splits = (min(config.num_train, default_tr) or default_tr,
                  min(config.num_val, default_val) or default_val)
        ds = SplineDataset(config.dataset, config.batch_size, grid,
                           closed=closed, seed=config.seed, splits=splits)
        test_gen = ds.load_test_data(anisotropic=anisotropic)
        if num_batches is None:
            num_batches = max(ds.test_points.shape[0] // config.batch_size
                              - 1, 1)
    num_batches = num_batches or 1
    nu, nv = (torch.from_numpy(a).to(dev) for a in uniform_knot_bspline(
        grid + int(closed), grid, 3, 3, SAMPLE_GRID))

    def surface(cp):
        cp = cp.reshape(-1, grid, grid, 3)
        return sample_surface(nu, nv, close_control_grid(cp) if closed
                              else cp)

    cds, cds_opt = [], []
    for b in range(num_batches):
        points, cps, scales, _ = next(test_gen)
        pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
        cps = torch.from_numpy(np.asarray(cps, np.float32)).to(dev)
        out = model(pts)
        if anisotropic:
            out, pts, cps = rescale_outputs(
                torch.from_numpy(np.asarray(scales, np.float32)).to(dev),
                out, pts, cps)
        recon = surface(out)
        # two-sided sqrt chamfer between the (wrap-aware) sampled surface
        # and the input points (reference:
        # test_closed_control_points.py:120-150)
        cds.append(float(chamfer_distance(recon, pts, sqrt=True)))
        if if_optimize or export_dir:
            recon_np = recon.cpu().numpy()
            gt_np = surface(cps).cpu().numpy()
            pts_np = pts.cpu().numpy()
            for i in range(recon_np.shape[0]):
                if if_optimize:
                    refined = optimize_spline_kronecker(
                        recon_np[i], pts_np[i], closed=closed,
                        grid_u=SAMPLE_GRID, grid_v=SAMPLE_GRID,
                        eval_grid=(SAMPLE_GRID, SAMPLE_GRID))
                    cds_opt.append(_refit_chamfer(refined, pts_np[i]))
                if export_dir:
                    os.makedirs(export_dir, exist_ok=True)
                    for tag, s in (("pred", recon_np[i]), ("gt", gt_np[i])):
                        v, t = tessellate_grid(s, SAMPLE_GRID, SAMPLE_GRID,
                                               wrap_u=closed)
                        write_ply(f"{export_dir}/{tag}_{b}_{i}.ply", v, t)
        log.info("batch %d cd %.5f", b, cds[-1])
    result = {"cd": float(np.mean(cds))}
    if cds_opt:
        result["cd_optim"] = float(np.mean(cds_opt))
    log.info("MEAN test cd %.5f%s", result["cd"],
             f" optim {result['cd_optim']:.5f}" if cds_opt else "")
    return result
