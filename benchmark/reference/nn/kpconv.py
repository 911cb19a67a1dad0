"""KPConv layer and block set (twin of ``rdmnet_tpu/nn/kpconv.py``).

Unbatched (N, C) point features over the padded/sentinel ABI: neighbour
gathers use sentinel-index fill rows, GroupNorm statistics cover valid points
only. Submodule and parameter names follow the flax tree so converted
weights load by name (``utils/convert.py``).

``dtype`` is the compute dtype (``nn/precision.py``): KPConv's two products
take it with a float32 result, dense layers run in it, and the norms compute
in float32 and cast their output to it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from benchmark.reference.nn.kernel_points import make_kernel_points
from benchmark.reference.nn.precision import Dense, matmul_f32
from benchmark.reference.ops.geometry import take_padded

INF_POINT = 1.0e6  # coordinate of a missing neighbour


def gather_neighbors(x: torch.Tensor, indices: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """(N, C) gathered by (M, H) sentinel-padded indices -> (M, H, C)."""
    return take_padded(x, indices, fill_value=fill)


def maxpool(x: torch.Tensor, neighbor_indices: torch.Tensor) -> torch.Tensor:
    """Neighbourhood max-pool; missing neighbours contribute 0."""
    return gather_neighbors(x, neighbor_indices, fill=0.0).amax(dim=1)


def nearest_upsample(x: torch.Tensor, upsample_indices: torch.Tensor) -> torch.Tensor:
    """Each query's nearest support feature (first table column), 0 if missing."""
    return take_padded(x, upsample_indices[:, 0], fill_value=0.0)


def knn_interpolate(s_feats: torch.Tensor, q_points: torch.Tensor, s_points: torch.Tensor,
                    neighbor_indices: torch.Tensor, k: int, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance interpolation of ``s_feats`` (N, C) at ``q_points``
    (M, 3) over the first ``k`` columns of ``neighbor_indices`` (M, H);
    missing neighbours weigh 0 -> (M, C)."""
    knn_indices = neighbor_indices[:, :k]
    knn_points = gather_neighbors(s_points, knn_indices, fill=0.0)
    knn_feats = gather_neighbors(s_feats, knn_indices, fill=0.0)
    sq = ((q_points[:, None] - knn_points) ** 2).sum(-1)
    masks = (knn_indices < s_points.shape[0]).to(s_feats.dtype)
    w = masks / (sq + eps)
    w = w / (w.sum(dim=1, keepdim=True) + eps)
    return (knn_feats * w[..., None]).sum(dim=1)


def global_avgpool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of the valid rows of a padded cloud (N, C) -> (C,); 0 if none."""
    m = mask.to(x.dtype)[:, None]
    return (x * m).sum(dim=0) / torch.clamp_min(m.sum(), 1.0)


def kpconv_influence(q_points, s_points, neighbor_indices, kernel_points, sigma: float) -> torch.Tensor:
    """Linear-correlation influence of each kernel point for every
    (query, neighbour) pair -> (M, H, K). Depends on geometry only."""
    nbr_pts = gather_neighbors(s_points, neighbor_indices, fill=INF_POINT)
    offsets = nbr_pts - q_points[:, None, :]
    diff = offsets[:, :, None, :] - kernel_points[None, None, :, :]
    sq_dist = (diff * diff).sum(-1)
    return torch.clamp_min(1.0 - torch.sqrt(sq_dist) / sigma, 0.0)


class KPConv(nn.Module):
    """Kernel-point convolution: (s_feats (N, Cin), q_points (M, 3),
    s_points (N, 3), neighbor_indices (M, H)) -> (M, Cout)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 15,
                 radius: float = 1.275, sigma: float = 0.6, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sigma = sigma
        self.dtype = dtype
        self.weights = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.register_buffer("kernel_points",
                             torch.from_numpy(make_kernel_points(radius, kernel_size)))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, s_feats, q_points, s_points, neighbor_indices,
                influence: Optional[torch.Tensor] = None,
                nbr_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        if influence is None:
            influence = kpconv_influence(q_points, s_points, neighbor_indices,
                                         self.kernel_points, self.sigma)
        if nbr_feats is None:
            nbr_feats = gather_neighbors(s_feats, neighbor_indices, fill=0.0)  # (M, H, C)
        m, dt = influence.shape[0], self.dtype
        weighted = matmul_f32(influence.transpose(1, 2).to(dt), nbr_feats.to(dt))  # (M, K, C)
        out = matmul_f32(weighted.reshape(m, -1).to(dt),
                         self.weights.reshape(-1, self.weights.shape[-1]).to(dt))
        # neighbour-count normalisation: neighbours whose gathered row sums > 0
        nbr_num = (nbr_feats.sum(-1) > 0.0).sum(-1).to(out.dtype)
        out = out / torch.clamp_min(nbr_num, 1.0)[:, None]
        if self.bias is not None:
            out = out + self.bias
        return out


class MaskedGroupNorm(nn.Module):
    """GroupNorm over a point cloud with statistics over valid points only."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert num_channels % num_groups == 0
        self.num_groups = num_groups
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x.float()
        n, c = x.shape
        g = self.num_groups
        m = mask.to(x.dtype)[:, None]
        xg = (x * m).reshape(n, g, c // g)
        count = torch.clamp_min(m.sum(), 1.0) * (c // g)
        mean = xg.sum(dim=(0, 2)) / count
        centered = (x.reshape(n, g, c // g) - mean[None, :, None]) * m[:, :, None]
        var = (centered * centered).sum(dim=(0, 2)) / count
        out = centered * torch.rsqrt(var + self.eps)[None, :, None]
        return (out.reshape(n, c) * self.weight + self.bias).to(self.dtype)


class UnaryBlock(nn.Module):
    """Linear -> masked GroupNorm -> LeakyReLU(0.1)."""

    def __init__(self, in_channels: int, out_channels: int, group_norm: int, has_relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = Dense(in_channels, out_channels, dtype=dtype)
        self.norm = MaskedGroupNorm(group_norm, out_channels, dtype=dtype)
        self.has_relu = has_relu

    def forward(self, x, mask):
        x = self.norm(self.mlp(x), mask)
        return F.leaky_relu(x, 0.1) if self.has_relu else x


class LastUnaryBlock(nn.Module):
    """Plain linear head in float32: flax's ``Dense`` without a dtype computes
    in the promoted type of its input and float32 weights."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.mlp = nn.Linear(in_channels, out_channels)

    def forward(self, x):
        return self.mlp(x.float())


class ConvBlock(nn.Module):
    """KPConv -> masked GroupNorm -> LeakyReLU(0.1)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.KPConv = KPConv(in_channels, out_channels, kernel_size, radius, sigma, dtype=dtype)
        self.norm = MaskedGroupNorm(group_norm, out_channels, dtype=dtype)

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_mask,
                influence=None, nbr_feats=None):
        x = self.KPConv(s_feats, q_points, s_points, neighbor_indices,
                        influence=influence, nbr_feats=nbr_feats)
        return F.leaky_relu(self.norm(x, q_mask), 0.1)


class ResidualBlock(nn.Module):
    """Bottleneck residual KPConv block."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm,
                 strided: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = out_channels // 4
        self.strided = strided
        self.unary1 = (UnaryBlock(in_channels, mid, group_norm, dtype=dtype)
                       if in_channels != mid else None)
        self.KPConv = KPConv(mid, mid, kernel_size, radius, sigma, dtype=dtype)
        self.norm_conv = MaskedGroupNorm(group_norm, mid, dtype=dtype)
        self.unary2 = UnaryBlock(mid, out_channels, group_norm, has_relu=False, dtype=dtype)
        self.unary_shortcut = (UnaryBlock(in_channels, out_channels, group_norm, has_relu=False,
                                          dtype=dtype)
                               if in_channels != out_channels else None)

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_mask, s_mask,
                influence=None):
        x = self.unary1(s_feats, s_mask) if self.unary1 is not None else s_feats
        x = self.KPConv(x, q_points, s_points, neighbor_indices, influence=influence)
        x = F.leaky_relu(self.norm_conv(x, q_mask), 0.1)
        x = self.unary2(x, q_mask)
        shortcut = maxpool(s_feats, neighbor_indices) if self.strided else s_feats
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_mask)
        return F.leaky_relu(x + shortcut, 0.1)
