"""DGCNN / EdgeConv segmentation network.

Counterpart of parsenet_tpu/models/dgcnn.py (reference src/PointNet.py:
143-289, DGCNNEncoderGn + PrimitivesEmbeddingDGCNGn):

  3 EdgeConvs (64, 64, 128 channels, GroupNorm, LeakyReLU 0.2, k=80) ->
  concat skip 256 -> 1x1 conv 1024 + GroupNorm + global max-pool ->
  broadcast concat -> 512 -> 256 -> {embedding 256->128, types 256->10}

Layout is the JAX package's: points-major [B, N, C]. GroupNorm keeps the
flax formula, var = max(0, E[x^2] - E[x]^2) (torch.nn.GroupNorm takes a
two-pass variance), so the carried-across weights give the same numbers.
Everything but the kNN indices is differentiable (the trainers'
networks); `params_from_jax` / `params_to_jax` carry weights to and from
the flat flax layout of params/parsenet_e2e.npz, and `init_flax_like`
draws flax's initialisers.

`dtype=torch.bfloat16` is the JAX package's bf16 network (the trainers'
half_precision, the bench's BENCH_DGCNN_BF16): parameters stay f32 and are
cast inside `forward`, so autograd hands f32 gradients to them; every
Dense runs in bf16, GroupNorm statistics in f32, activations are cast back
to bf16 after each relu, and the embedding and the type log-probs return
as f32. `gather_bf16` gathers a bf16 copy of the EdgeConv neighbour
values; `remat` recomputes each EdgeConv in the backward pass
(torch.utils.checkpoint) instead of keeping its activations.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...): input, kernel and bias cast to `dtype`, the
    product (f32 accumulation) rounded to `dtype`, then the bias added in
    `dtype`, as flax's dot_general and add round it. For f32 it is
    layer(x)."""
    if dtype == torch.float32:
        return layer(x.to(dtype))
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def norm_relu(gn: "GroupNorm", h: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """relu(GroupNorm(h)) with the statistics in f32, cast to `dtype`."""
    return torch.relu(gn(h.to(torch.float32))).to(dtype)


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
                 negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.float32,
                 gather_bf16: bool = False):
        super().__init__()
        self.groups = groups
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.gather_bf16 = gather_bf16
        self.w_diff = nn.Linear(in_features, features, bias=False)
        self.w_center = nn.Linear(in_features, features, bias=False)
        self.GroupNorm_0 = GroupNorm(groups, features)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        # x: [B, N, C], idx: [B, N, k] -> [B, N, features] in self.dtype;
        # yd and yx rounded to self.dtype, the statistics taken in f32
        x = x.to(self.dtype)
        yd = dense(self.w_diff, x, self.dtype)
        yx = (dense(self.w_center, x, self.dtype) - yd).to(torch.float32)
        gsrc = yd.to(torch.bfloat16) if self.gather_bf16 else yd
        yd = yd.to(torch.float32)
        n, k = x.shape[1], idx.shape[2]
        g = knn_ops.gather_neighbors(gsrc, idx).to(
            torch.float32)                                  # [B, N, k, C]
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
                            self.negative_slope).to(self.dtype)


class DGCNNEncoder(nn.Module):
    """mode 0: xyz input; mode 5: xyz + normals with the joint point/normal
    kNN metric in the first layer. dtype, gather_bf16 and remat: see the
    module docstring."""

    def __init__(self, mode: int = 0, k: int = 80,
                 dtype: torch.dtype = torch.float32,
                 gather_bf16: bool = False, remat: bool = False):
        super().__init__()
        if mode not in (0, 5):
            raise ValueError(f"DGCNNEncoder: mode {mode} not ported (0, 5)")
        self.mode = mode
        self.k = k
        self.dtype = dtype
        self.remat = remat
        c_in = 6 if mode == 5 else 3
        kw = dict(groups=2, dtype=dtype, gather_bf16=gather_bf16)
        self.conv1 = EdgeConv(c_in, 64, **kw)
        self.conv2 = EdgeConv(64, 64, **kw)
        self.conv3 = EdgeConv(64, 128, **kw)
        self.mlp1 = nn.Linear(256, 1024)
        self.bnmlp1 = GroupNorm(8, 1024)

    def _edge(self, conv: EdgeConv, x: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(conv, x, idx, use_reentrant=False)
        return conv(x, idx)

    def forward(self, x: torch.Tensor):
        # x: [B, N, C_in] -> (global [B, 1024], skip [B, N, 256]) in dtype;
        # the kNN graphs are built outside the recomputed EdgeConvs
        idx = knn_ops.knn_graph(x, self.k, points_normals=self.mode == 5)
        x1 = self._edge(self.conv1, x, idx)
        x2 = self._edge(self.conv2, x1, knn_ops.knn_graph(x1, self.k))
        x3 = self._edge(self.conv3, x2, knn_ops.knn_graph(x2, self.k))
        feats = torch.cat([x1, x2, x3], dim=-1)              # [B, N, 256]
        h = norm_relu(self.bnmlp1, dense(self.mlp1, feats, self.dtype),
                      self.dtype)
        return torch.amax(h, dim=1), feats


class PrimitivesEmbedding(nn.Module):
    """Returns (embedding [B, N, emb_size], primitive log-probs [B, N, P]),
    both f32 whatever the compute dtype."""

    def __init__(self, emb_size: int = 128, num_primitives: int = 10,
                 mode: int = 0, k: int = 80,
                 dtype: torch.dtype = torch.float32,
                 gather_bf16: bool = False, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.encoder = DGCNNEncoder(mode=mode, k=k, dtype=dtype,
                                    gather_bf16=gather_bf16, remat=remat)
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
        dt = self.dtype
        h = torch.cat([global_feat[:, None, :].expand(b, n, 1024), skip], -1)
        h = norm_relu(self.bn1, dense(self.conv1, h, dt), dt)
        h_all = norm_relu(self.bn2, dense(self.conv2, h, dt), dt)
        e = norm_relu(self.bn_seg_prob1, dense(self.mlp_seg_prob1, h_all, dt),
                      dt)
        embedding = dense(self.mlp_seg_prob2, e, dt).to(torch.float32)
        p = norm_relu(self.bn_prim_prob1,
                      dense(self.mlp_prim_prob1, h_all, dt), dt)
        prim_log_prob = torch.log_softmax(
            dense(self.mlp_prim_prob2, p, dt).to(torch.float32), dim=-1)
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


def _flax_leaves(model: nn.Module):
    """(state_dict name, flax key, is a Dense kernel) of every parameter."""
    for mname, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, GroupNorm)):
            for leaf in ("weight", "bias"):
                if getattr(mod, leaf, None) is None:
                    continue
                flax_leaf = leaf if leaf == "bias" else (
                    "kernel" if isinstance(mod, nn.Linear) else "scale")
                yield (f"{mname}.{leaf}",
                       "/".join(["params"] + mname.split(".") + [flax_leaf]),
                       flax_leaf == "kernel")


def params_to_jax(model: nn.Module) -> dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: {"params/...": f32 ndarray} in the
    flat flax layout of params/parsenet_e2e.npz (Dense kernels [in, out]),
    which parsenet_tpu.core.checkpoint.load_npz_params reads."""
    sd = model.state_dict()
    out = {}
    for name, key, kernel in _flax_leaves(model):
        a = sd[name].detach().to("cpu", torch.float32)
        out[key] = (a.T if kernel else a).contiguous().numpy()
    return out


def init_flax_like(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: Dense kernels lecun_normal (a normal of variance
    1 / fan_in truncated at 2 standard deviations), biases 0, GroupNorm
    scale 1 and bias 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = (1.0 / mod.in_features) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


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
