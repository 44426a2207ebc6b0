"""DGCNN / EdgeConv segmentation network (inference).

Counterpart of parsenet_tpu/models/dgcnn.py (reference src/PointNet.py:
143-289, DGCNNEncoderGn + PrimitivesEmbeddingDGCNGn):

  3 EdgeConvs (64, 64, 128 channels, GroupNorm, LeakyReLU 0.2, k=80) ->
  concat skip 256 -> 1x1 conv 1024 + GroupNorm + global max-pool ->
  broadcast concat -> 512 -> 256 -> {embedding 256->128, types 256->10}

Layout is the JAX package's: points-major [B, N, C]. GroupNorm keeps the
flax formula, var = max(0, E[x^2] - E[x]^2) (torch.nn.GroupNorm takes a
two-pass variance), so the carried-across weights give the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import knn as knn_ops


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """flax.linen.GroupNorm on [B, N, C]: statistics over (N, C/G) per group."""
    b, n, c = x.shape
    xg = x.reshape(b, n, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (xg - mean) * torch.rsqrt(var + eps)
    return y.reshape(b, n, c) * weight + bias


class GroupNorm(nn.Module):
    """GroupNorm parameters (weight = flax `scale`, bias) with the flax
    statistics of `group_norm`."""

    def __init__(self, groups: int, features: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.groups, self.weight, self.bias)


class EdgeConv(nn.Module):
    """max_j LReLU(GN(W [x_j - x_i; x_i])) without the [B, N, k, 2C] edge
    tensor.

    W = [W_d | W_x] is applied before the gather: edge_j = yd_j + yx_i with
    yd = W_d x and yx = (W_x - W_d) x. GroupNorm is a per-channel affine map
    once its statistics are known and LeakyReLU is monotone, so one gather
    of yd gives four neighbour reductions (sum, sum of squares, max, min):
    the statistics expand into them, and the max over j is the max (or min,
    where the affine slope is negative) of yd_j plus yx_i.
    """

    def __init__(self, in_features: int, features: int, groups: int,
                 negative_slope: float = 0.2):
        super().__init__()
        self.groups = groups
        self.negative_slope = negative_slope
        self.w_diff = nn.Linear(in_features, features, bias=False)
        self.w_center = nn.Linear(in_features, features, bias=False)
        self.GroupNorm_0 = GroupNorm(groups, features)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        # x: [B, N, C], idx: [B, N, k] -> [B, N, features]
        yd = self.w_diff(x)
        yx = self.w_center(x) - yd
        n, k = x.shape[1], idx.shape[2]
        g = knn_ops.gather_neighbors(yd, idx)               # [B, N, k, C]
        nb_sum = torch.sum(g, dim=2)
        nb_sq = torch.sum(g * g, dim=2)
        nb_max = torch.amax(g, dim=2)
        nb_min = torch.amin(g, dim=2)
        del g

        b, c, gr = x.shape[0], yd.shape[-1], self.groups
        e_sum = nb_sum + k * yx
        e_sq = nb_sq + 2.0 * yx * nb_sum + k * yx * yx
        denom = n * k * (c // gr)
        mean = torch.sum(e_sum.reshape(b, n, gr, c // gr), dim=(1, 3)) / denom
        m2 = torch.sum(e_sq.reshape(b, n, gr, c // gr), dim=(1, 3)) / denom
        var = m2 - mean * mean
        inv = torch.rsqrt(var + 1e-5)                        # [B, G]
        inv_c = torch.repeat_interleave(inv, c // gr, dim=1)  # [B, C]
        mean_c = torch.repeat_interleave(mean, c // gr, dim=1)
        a = self.GroupNorm_0.weight[None, :] * inv_c
        bb = self.GroupNorm_0.bias[None, :] - mean_c * a
        ext = torch.where(a[:, None, :] >= 0, nb_max, nb_min) + yx
        return F.leaky_relu(a[:, None, :] * ext + bb[:, None, :],
                            self.negative_slope)


class DGCNNEncoder(nn.Module):
    """mode 0: xyz input; mode 5: xyz + normals with the joint point/normal
    kNN metric in the first layer."""

    def __init__(self, mode: int = 0, k: int = 80):
        super().__init__()
        if mode not in (0, 5):
            raise ValueError(f"DGCNNEncoder: mode {mode} not ported (0, 5)")
        self.mode = mode
        self.k = k
        c_in = 6 if mode == 5 else 3
        self.conv1 = EdgeConv(c_in, 64, groups=2)
        self.conv2 = EdgeConv(64, 64, groups=2)
        self.conv3 = EdgeConv(64, 128, groups=2)
        self.mlp1 = nn.Linear(256, 1024)
        self.bnmlp1 = GroupNorm(8, 1024)

    def forward(self, x: torch.Tensor):
        # x: [B, N, C_in] -> (global [B, 1024], skip [B, N, 256])
        if self.mode == 5:
            idx = knn_ops.knn_points_normals(x, k1=self.k, k2=self.k)
        else:
            idx = knn_ops.knn(x, k1=self.k, k2=self.k)
        x1 = self.conv1(x, idx)
        x2 = self.conv2(x1, knn_ops.knn(x1, k1=self.k, k2=self.k))
        x3 = self.conv3(x2, knn_ops.knn(x2, k1=self.k, k2=self.k))
        feats = torch.cat([x1, x2, x3], dim=-1)              # [B, N, 256]
        h = torch.relu(self.bnmlp1(self.mlp1(feats)))
        return torch.amax(h, dim=1), feats


class PrimitivesEmbedding(nn.Module):
    """Returns (embedding [B, N, emb_size], primitive log-probs [B, N, P])."""

    def __init__(self, emb_size: int = 128, num_primitives: int = 10,
                 mode: int = 0, k: int = 80):
        super().__init__()
        self.encoder = DGCNNEncoder(mode=mode, k=k)
        self.conv1 = nn.Linear(1024 + 256, 512)
        self.bn1 = GroupNorm(8, 512)
        self.conv2 = nn.Linear(512, 256)
        self.bn2 = GroupNorm(4, 256)
        self.mlp_seg_prob1 = nn.Linear(256, 256)
        self.bn_seg_prob1 = GroupNorm(4, 256)
        self.mlp_seg_prob2 = nn.Linear(256, emb_size)
        self.mlp_prim_prob1 = nn.Linear(256, 256)
        self.bn_prim_prob1 = GroupNorm(4, 256)
        self.mlp_prim_prob2 = nn.Linear(256, num_primitives)

    def forward(self, points: torch.Tensor):
        b, n = points.shape[0], points.shape[1]
        global_feat, skip = self.encoder(points)
        h = torch.cat([global_feat[:, None, :].expand(b, n, 1024), skip], -1)
        h = torch.relu(self.bn1(self.conv1(h)))
        h_all = torch.relu(self.bn2(self.conv2(h)))
        e = torch.relu(self.bn_seg_prob1(self.mlp_seg_prob1(h_all)))
        embedding = self.mlp_seg_prob2(e)
        p = torch.relu(self.bn_prim_prob1(self.mlp_prim_prob1(h_all)))
        prim_log_prob = torch.log_softmax(self.mlp_prim_prob2(p), dim=-1)
        return embedding, prim_log_prob


def params_from_jax(flat: dict[str, np.ndarray],
                    model: nn.Module) -> dict[str, torch.Tensor]:
    """flax parameter export -> state_dict.

    flat: {"params/encoder/conv1/w_diff/kernel": ndarray, ...} as
    core.checkpoint.load_npz_params returns it. A flax Dense `kernel`
    [in, out] becomes nn.Linear.weight [out, in]; a GroupNorm `scale` becomes
    `weight`; `bias` stays `bias`. Every key must land on one of `model`'s
    parameters with the same shape and every parameter must be set:
    anything left over on either side raises.
    """
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] != "params" or parts[-1] not in ("kernel", "scale", "bias"):
            raise KeyError(f"params_from_jax: unexpected key {key!r}")
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[parts[-1]]
        t = torch.from_numpy(np.asarray(arr, np.float32))
        if parts[-1] == "kernel":
            t = t.T.contiguous()
        sd[".".join(parts[1:-1] + [leaf])] = t
    want = {k: v.shape for k, v in model.state_dict().items()}
    unused = sorted(set(sd) - set(want))
    unset = sorted(set(want) - set(sd))
    bad = sorted(k for k in set(sd) & set(want) if sd[k].shape != want[k])
    if unused or unset or bad:
        raise KeyError(f"params_from_jax: unused {unused}, unset {unset}, "
                       f"shape mismatch {bad}")
    return sd


def load_primitives_embedding(path: str, mode: int = 5, k: int = 80,
                              emb_size: int = 128, num_primitives: int = 10,
                              device=None) -> PrimitivesEmbedding:
    """The shipped flax export at `path` carried into a PrimitivesEmbedding
    in eval mode on `device` (None = "cuda")."""
    from ..core.checkpoint import load_npz_params
    from ..core.guards import entry_device
    dev = entry_device(device)
    model = PrimitivesEmbedding(emb_size=emb_size,
                                num_primitives=num_primitives, mode=mode, k=k)
    model.load_state_dict(params_from_jax(load_npz_params(path), model))
    return model.to(dev).eval()
