"""Batch-sharded inference over the ranks of a process group.

Counterpart of parsenet_tpu/eval/sharded.py: the per-shape program
(segmentation forward -> mean-shift -> SIOU -> fits -> residual and
coverage, eval.pipeline) runs data-parallel over a parallel.mesh.Mesh. Each
rank takes its slice of the shape batch, runs its shapes one at a time as
the JAX package's vmapped shape_pipeline does (the network on [1, N]), and
the four metric sums (residual, seg_iou, p_cov, sk_2) are added over the
ranks by one all-reduce.

Draws are per shape, never a stream threaded through the batch: shape i
of a batch with seed s draws everything (the bandwidth subset, the
coverage uniforms, the spline slots' uniforms) from its own
torch.Generator seeded `shape_seed(s, i)`, i its index in the GLOBAL
batch, as the JAX package splits one key a shape. So a shape's metrics do
not depend on which rank runs it, and W ranks give one rank's metrics bit
for bit. (eval.pipeline.batch_metrics, the unsharded bench's path, keeps its
single generator and its numbers.) Explicit draws (`ShapeDraws` a shape)
replace the generators, which the tests use to feed the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.guards import entry_device
from ..parallel.mesh import shard_slice
from .pipeline import _as_tensor, predict_segmentation, reconstruct_shape

SUMS = ("residual", "seg_iou", "p_cov", "sk_2")


class ShapeDraws(NamedTuple):
    """One shape's draws: the bandwidth subset [S] (None: the first S rows),
    the coverage uniforms [COV_SAMPLES] and the spline slots' uniforms
    (reconstruct_shape's slot_uniforms; None without decoders)."""
    subset: Optional[torch.Tensor]
    uniforms: torch.Tensor
    slot_uniforms: Optional[object] = None


def shape_seed(batch_seed: int, index: int) -> int:
    """The seed of shape `index` (global) of a batch drawn with batch_seed."""
    return int(np.random.SeedSequence([int(batch_seed), int(index)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_shape_pipeline(model, spline_fit, ms_bf16: bool = False,
                        ms_num_samples: int = 5000, ms_iterations: int = 50,
                        eval_preprocess: bool = True, device=None):
    """shape_pipeline(points [N, 3], normals, labels [N], prim [N], draws)
    -> (SegmentationPrediction of a batch of one, Reconstruction): one
    shape through predict_segmentation and reconstruct_shape. draws: a
    torch.Generator on the device, or a ShapeDraws."""
    dev = entry_device(device)

    def shape_pipeline(p, n, lab, pr, draws):
        gen = draws if isinstance(draws, torch.Generator) else None
        pred = predict_segmentation(
            model, p[None], n[None], lab[None], pr[None],
            iterations=ms_iterations, ms_num_samples=ms_num_samples,
            ms_bf16=ms_bf16, generator=gen, device=dev,
            subsets=(None if gen is not None or draws.subset is None
                     else draws.subset[None]))
        rec = reconstruct_shape(
            p, n, pred.labels[0], pred.pred_prim[0], generator=gen,
            uniforms=None if gen is not None else draws.uniforms,
            slot_uniforms=None if gen is not None else draws.slot_uniforms,
            spline_fit=spline_fit, eval_preprocess=eval_preprocess,
            device=dev)
        return pred, rec

    return shape_pipeline


class BatchedEval:
    """The batched metric program of `make_batched_eval`."""

    def __init__(self, shape_pipeline, mesh, device):
        self.shape_pipeline, self.mesh, self.device = (shape_pipeline, mesh,
                                                       device)

    def _draws(self, b: int, seed: Optional[int],
               draws: Optional[Sequence[ShapeDraws]], i: int):
        if draws is not None:
            if len(draws) != b:
                raise ValueError(f"batched eval: {len(draws)} draws for "
                                 f"{b} shapes")
            return draws[i]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(shape_seed(seed, i))
        return gen

    def shape_metrics(self, points, normals, labels, prim,
                      seed: Optional[int] = None,
                      draws: Optional[Sequence[ShapeDraws]] = None
                      ) -> torch.Tensor:
        """[B_local, 4] (SUMS order) of this rank's shapes of the global
        batch points/normals [B, N, 3], labels/prim [B, N]: shape i takes
        shape_seed(seed, i)'s generator, or draws[i]."""
        b = len(points)
        if (seed is None) == (draws is None):
            raise ValueError("batched eval: pass a seed or the draws")
        rows = []
        for i in range(b)[shard_slice(b, self.mesh)]:
            pred, rec = self.shape_pipeline(
                _as_tensor(points[i], self.device, torch.float32),
                _as_tensor(normals[i], self.device, torch.float32),
                _as_tensor(labels[i], self.device, torch.int64),
                _as_tensor(prim[i], self.device, torch.int64),
                self._draws(b, seed, draws, i))
            rows.append(torch.stack([rec.residual, pred.seg_iou[0],
                                     rec.p_cov, rec.sk_2]))
        return torch.stack(rows)

    def __call__(self, points, normals, labels, prim,
                 seed: Optional[int] = None,
                 draws: Optional[Sequence[ShapeDraws]] = None
                 ) -> torch.Tensor:
        """[4] sums (SUMS order) over the global batch, the same on every
        rank; no host fetch."""
        sums = torch.sum(self.shape_metrics(points, normals, labels, prim,
                                            seed, draws), dim=0)
        return sums if self.mesh is None else self.mesh.all_sum(sums)


def make_batched_eval(model, spline_fit, mesh=None, device=None,
                      **pipeline_kw) -> BatchedEval:
    """The batched metric program (parsenet_tpu/eval/sharded.py:51-72):
    batched(points, normals, labels, prim, seed) -> [4] sums of (residual,
    seg_iou, p_cov, sk_2) over the batch. mesh=None: every shape here.
    mesh: a parallel.mesh.Mesh; each rank runs its slice of the batch axis
    and the sums are all-reduced. The per-shape program and its draws are
    the same either way (module docstring). pipeline_kw: ms_bf16,
    ms_num_samples, ms_iterations, eval_preprocess."""
    dev = mesh.device if mesh is not None else entry_device(device)
    return BatchedEval(make_shape_pipeline(model, spline_fit, device=dev,
                                           **pipeline_kw), mesh, dev)
