"""KPConv-FPN backbone: 5-stage encoder, 3-stage decoder
(twin of ``rdmnet_tpu/nn/backbone.py``).

Channel schedule 1 -> 64 -> 128 -> 256 -> 512 -> 1024 -> 2048 on the
encoder; the decoder takes the transformer-conditioned coarse features
(output_dim + 1 score channel) and emits fine features (output_dim + 1).
Runs on the stacked pair graph (``graph.pyramid.StackedGraph``). Both cast
their input features to the compute ``dtype`` (``nn/precision.py``); the
decoder's last head returns float32.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from benchmark.reference.config import BackboneConfig
from benchmark.reference.nn.kernel_points import make_kernel_points
from benchmark.reference.nn.kpconv import (
    ConvBlock,
    LastUnaryBlock,
    ResidualBlock,
    UnaryBlock,
    kpconv_influence,
    nearest_upsample,
)


class Encoder(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        self.dtype = dt = dtype
        d, r, s, ks, gn = c.init_dim, c.init_radius, c.init_sigma, c.kernel_size, c.group_norm
        self.encoder1_1 = ConvBlock(c.input_dim, d, ks, r, s, gn, dtype=dt)
        self.encoder1_2 = ResidualBlock(d, d * 2, ks, r, s, gn, dtype=dt)
        stage_dims = [(d * 2, d * 4), (d * 4, d * 8), (d * 8, d * 16), (d * 16, d * 32)]
        for i, (din, dout) in enumerate(stage_dims):
            lvl = i + 1
            r1, s1 = r * 2 ** (i + 1), s * 2 ** (i + 1)
            setattr(self, f"encoder{lvl + 1}_1",
                    ResidualBlock(din, din, ks, r * 2 ** i, s * 2 ** i, gn, strided=True,
                                  dtype=dt))
            setattr(self, f"encoder{lvl + 1}_2", ResidualBlock(din, dout, ks, r1, s1, gn, dtype=dt))
            setattr(self, f"encoder{lvl + 1}_3",
                    ResidualBlock(dout, dout, ks, r1, s1, gn, dtype=dt))
        # canonical kernel dispositions of the shared per-level influences
        for lvl in range(c.num_stages):
            self.register_buffer(
                f"shared_kernel_points_{lvl}",
                torch.from_numpy(make_kernel_points(r * 2 ** lvl, ks)), persistent=False)

    def forward(self, feats: torch.Tensor, pyr) -> List[torch.Tensor]:
        c = self.cfg
        r, s = c.init_radius, c.init_sigma
        feats = feats.to(self.dtype)
        pts, nbrs, subs = pyr.points, pyr.neighbors, pyr.subsampling
        masks = [pyr.mask(i) for i in range(pyr.num_stages)]

        # blocks sharing (points, neighbours, radius) share one influence
        # tensor when every layer uses the canonical kernel disposition
        def self_influence(lvl):
            if not c.shared_influence:
                return None
            return kpconv_influence(pts[lvl], pts[lvl], nbrs[lvl],
                                    getattr(self, f"shared_kernel_points_{lvl}"),
                                    s * 2 ** lvl)

        infl0 = self_influence(0)
        nbr_feats0 = None
        if c.ones_input and c.input_dim == 1:
            # all-ones input: gathered level-0 features == neighbour validity
            nbr_feats0 = pyr.index_valid(0, nbrs[0])[..., None].to(feats.dtype)
        x = self.encoder1_1(feats, pts[0], pts[0], nbrs[0], masks[0], influence=infl0,
                            nbr_feats=nbr_feats0)
        x = self.encoder1_2(x, pts[0], pts[0], nbrs[0], masks[0], masks[0], influence=infl0)
        feats_list = [x]
        for lvl in range(1, c.num_stages):
            x = getattr(self, f"encoder{lvl + 1}_1")(
                x, pts[lvl], pts[lvl - 1], subs[lvl - 1], masks[lvl], masks[lvl - 1])
            infl = self_influence(lvl)
            x = getattr(self, f"encoder{lvl + 1}_2")(
                x, pts[lvl], pts[lvl], nbrs[lvl], masks[lvl], masks[lvl], influence=infl)
            x = getattr(self, f"encoder{lvl + 1}_3")(
                x, pts[lvl], pts[lvl], nbrs[lvl], masks[lvl], masks[lvl], influence=infl)
            feats_list.append(x)
        return feats_list


class Decoder(nn.Module):
    """3-stage FPN decoder with skip connections. ``feats_list[-1]`` is the
    transformer-conditioned coarse feature (output_dim + 1 channels).
    Returns [level-1, level-2, level-3] features."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, gn = cfg.init_dim, cfg.group_norm
        self.dtype = dtype
        self.decoder4 = UnaryBlock(cfg.output_dim + 1 + d * 16, d * 16, gn, dtype=dtype)
        self.decoder3 = UnaryBlock(d * 16 + d * 8, d * 8, gn, dtype=dtype)
        self.decoder2 = LastUnaryBlock(d * 8 + d * 4, cfg.output_dim + 1)

    def forward(self, feats_list: Sequence[torch.Tensor], pyr) -> List[torch.Tensor]:
        ups = pyr.upsampling
        masks = [pyr.mask(i) for i in range(pyr.num_stages)]
        feats_list = [f.to(self.dtype) for f in feats_list]
        x4 = nearest_upsample(feats_list[4], ups[3])
        x4 = self.decoder4(torch.cat([x4, feats_list[3]], dim=1), masks[3])
        x3 = nearest_upsample(x4, ups[2])
        x3 = self.decoder3(torch.cat([x3, feats_list[2]], dim=1), masks[2])
        x2 = nearest_upsample(x3, ups[1])
        x2 = self.decoder2(torch.cat([x2, feats_list[1]], dim=1))
        return [x2, x3, x4]
