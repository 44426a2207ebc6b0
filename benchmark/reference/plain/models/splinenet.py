"""SplineNet: the control-point decoder of the spline patches.

Counterpart of parsenet_tpu/models/splinenet.py (reference src/model.py:
56-180, DGCNNControlPoints): 4 EdgeConvs (mode 0, open: 64/64/128/256;
mode 1, closed: 128/256/256/512; k = 10), BatchNorm + LeakyReLU(0.2), concat
skips -> 1x1 conv 1024 -> optional per-point weight multiply -> global max
pool -> MLP 1024 -> 1024 -> 3 grid^2 -> tanh -> [B, grid^2, 3].

Every BatchNorm keeps flax's statistics, which torch's BatchNorm layers do
not: the batch variance is the biased E[x^2] - E[x]^2 (clipped at 0 in
bn5-bn7, as flax's fast variance is), and the running averages take it with
flax's momentum 0.9 (torch's 0.1) and the biased variance (torch's running
variance takes the unbiased one). So the statistics and the buffer updates
are written out here. Layout is the JAX package's: points-major [B, N, C].

The benchmark's frozen copy: one process, no data-parallel gather.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import knn as knn_ops

MOMENTUM = 0.9  # flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch
EPS = 1e-5


class BatchNorm(nn.Module):
    """flax BatchNorm parameters (weight = `scale`, bias) and running
    statistics (running_mean / running_var = batch_stats mean / var) over
    the last axis. In training the moments are taken over every other axis
    and the buffers are updated in place."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * mean)
            self.running_var.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            xg = x
            mean = torch.mean(xg, dim=axes)
            var = torch.clamp(torch.mean(xg * xg, dim=axes) - mean * mean,
                              min=0.0)
            self.update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + EPS) * self.weight) + self.bias


class EdgeConvBN(nn.Module):
    """EdgeConv + BatchNorm + LeakyReLU + max over neighbours, without the
    [B, N, k, C] edge tensor's normalisation: edge_j = yd_j + yx_i with
    yd = W_d x and yx = (W_x - W_d) x, so BatchNorm's moments expand into
    neighbour sums and sums of squares, and since BN is a per-channel affine
    map and LeakyReLU is monotone, the max over j is the neighbour max (or
    min, where the BN slope is negative) of yd_j plus yx_i. torch.amax /
    amin split the gradient evenly among ties, as JAX's max does."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.w_diff = nn.Linear(in_features, features, bias=False)
        self.w_center = nn.Linear(in_features, features, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        # x: [B, N, C], idx: [B, N, k] -> [B, N, features]
        yd = self.w_diff(x)
        yx = self.w_center(x) - yd
        b, n, k = x.shape[0], x.shape[1], idx.shape[2]
        g = knn_ops.gather_neighbors(yd, idx)               # [B, N, k, C]
        nb_sum = torch.sum(g, dim=2)
        nb_max = torch.amax(g, dim=2)
        nb_min = torch.amin(g, dim=2)
        if self.training:
            nb_sq = torch.sum(g * g, dim=2)
            e_sum = nb_sum + k * yx
            e_sq = nb_sq + 2.0 * yx * nb_sum + k * yx * yx
            cnt = e_sum.shape[0] * n * k
            mean = torch.sum(e_sum, dim=(0, 1)) / cnt
            var = torch.sum(e_sq, dim=(0, 1)) / cnt - mean * mean
            self.bn.update(mean, var)
        else:
            mean, var = self.bn.running_mean, self.bn.running_var
        del g
        a = self.bn.weight * torch.rsqrt(var + EPS)          # [C]
        bb = self.bn.bias - mean * a
        ext = torch.where(a >= 0, nb_max, nb_min) + yx
        return F.leaky_relu(a * ext + bb, self.negative_slope)


class SplineNet(nn.Module):
    """DGCNNControlPoints. grid: control-grid side (20); mode 0 open, 1
    closed. forward(points [B, N, 3], weights [B, N] or None) ->
    [B, grid^2, 3]; train/eval follows the module's training flag."""

    def __init__(self, grid: int = 20, k: int = 10, mode: int = 0):
        super().__init__()
        if mode not in (0, 1):
            raise ValueError(f"SplineNet: mode {mode} is not 0 or 1")
        self.grid, self.k, self.mode = grid, k, mode
        chans = (64, 64, 128, 256) if mode == 0 else (128, 256, 256, 512)
        c_in = 3
        for li, c in enumerate(chans):
            setattr(self, f"conv{li + 1}", EdgeConvBN(c_in, c))
            c_in = c
        self.conv5 = nn.Linear(sum(chans), 1024, bias=False)
        self.bn5 = BatchNorm(1024)
        self.conv6 = nn.Linear(1024, 1024)
        self.bn6 = BatchNorm(1024)
        self.conv7 = nn.Linear(1024, 1024)
        self.bn7 = BatchNorm(1024)
        self.conv8 = nn.Linear(1024, 3 * grid * grid)

    def forward(self, points: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = points
        skips = []
        for li in range(4):
            idx = knn_ops.knn(x, k1=self.k, k2=self.k)
            x = getattr(self, f"conv{li + 1}")(x, idx)
            skips.append(x)
        h = F.leaky_relu(self.bn5(self.conv5(torch.cat(skips, dim=-1))), 0.2)
        if weights is not None:
            h = h * weights[:, :, None]
        g = torch.amax(h, dim=1)                             # [B, 1024]
        g = torch.relu(self.bn6(self.conv6(g)))
        g = torch.relu(self.bn7(self.conv7(g)))
        out = torch.tanh(self.conv8(g))
        return out.reshape(points.shape[0], self.grid * self.grid, 3)


def _flax_key(name: str) -> str:
    """state_dict name -> flat flax key ("conv1.bn.running_mean" ->
    "batch_stats/conv1/bn/mean", "conv5.weight" -> "params/conv5/kernel")."""
    *path, leaf = name.split(".")
    if leaf in ("running_mean", "running_var"):
        return "/".join(["batch_stats", *path, leaf[len("running_"):]])
    is_bn = path[-1].startswith("bn")
    flax_leaf = {"weight": "scale" if is_bn else "kernel", "bias": "bias"}[leaf]
    return "/".join(["params", *path, flax_leaf])


def params_from_jax(flat: dict[str, np.ndarray],
                    model: SplineNet) -> dict[str, torch.Tensor]:
    """Flat flax export {"params/conv1/w_diff/kernel": ..., "batch_stats/
    conv1/bn/mean": ...} -> `model`'s state_dict (43 keys in either mode).
    A Dense kernel [in, out] becomes nn.Linear.weight [out, in]. Keys left
    over on either side, or a shape that does not fit, raise."""
    want = model.state_dict()
    keyed = {_flax_key(name): name for name in want}
    unused = sorted(set(flat) - set(keyed))
    unset = sorted(set(keyed) - set(flat))
    sd, bad = {}, []
    for key in sorted(set(flat) & set(keyed)):
        name = keyed[key]
        t = torch.tensor(np.asarray(flat[key], np.float32))
        if key.endswith("/kernel"):
            t = t.T.contiguous()
        if t.shape != want[name].shape:
            bad.append(key)
        sd[name] = t
    if unused or unset or bad:
        raise KeyError(f"params_from_jax: unused {unused}, unset {unset}, "
                       f"shape mismatch {bad}")
    return sd


def params_to_jax(model: SplineNet) -> dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: the flat flax layout of
    params/*.npz, f32, which parsenet_tpu.core.checkpoint.load_npz_params
    reads."""
    out = {}
    for name, t in model.state_dict().items():
        key = _flax_key(name)
        a = t.detach().to("cpu", torch.float32)
        out[key] = (a.T if key.endswith("/kernel") else a).contiguous().numpy()
    return out


def init_flax_like(model: SplineNet, generator: torch.Generator) -> None:
    """flax's initialisers: Dense kernels lecun_normal (a normal of variance
    1 / fan_in truncated at 2 standard deviations), biases 0, BatchNorm
    scale 1 and bias 0, running mean 0 and variance 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = (1.0 / mod.in_features) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)


def load_splinenet(path: str, mode: int, grid: int = 20, k: int = 10,
                   device=None) -> SplineNet:
    """A shipped flax export (params/{open,closed}_splinenet.npz) carried
    into a SplineNet in eval mode on `device` (None = "cuda")."""
    from ..core.checkpoint import load_npz_params
    from ..core.guards import entry_device
    dev = entry_device(device)
    model = SplineNet(grid=grid, k=k, mode=mode)
    model.load_state_dict(params_from_jax(load_npz_params(path), model))
    return model.to(dev).eval()
