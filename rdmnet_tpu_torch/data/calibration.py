"""Offline calibration of the pyramid's static capacities (twin of
``rdmnet_tpu/data/calibration.py``).

``calibrate_neighbor_limits`` histograms exact within-radius neighbour counts
per level over sample clouds and keeps the smallest K covering
``keep_ratio`` of the neighbourhoods (the reference's rule); the limits go
into ``PyramidConfig.neighbor_limits`` (any size: above 256 the radius-kNN
kernel takes its select path). ``calibrate_band_caps`` replays every search of the
pyramid build with the runtime's sort, chunk and margin rules and sizes the
banded windows (``PyramidConfig.band_caps``). Both run on the device they are
given (default CUDA): the counts, the subsampled levels and the sort keys
come from the port's own ops, the histograms and band occupancies are host
numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from rdmnet_tpu_torch.config import PyramidConfig
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.ops.geometry import pairwise_sq_dist
from rdmnet_tpu_torch.ops.grid_subsample import grid_subsample, voxel_sort_key
from rdmnet_tpu_torch.ops.radius_search import band_margin


def _neighbor_counts(points: torch.Tensor, count: int, radius: float,
                     chunk: int = 2048) -> np.ndarray:
    """Exact within-radius neighbour counts of the first ``count`` rows of
    ``points`` (N, 3) among those rows, ``chunk`` queries at a time, on the
    distances' XLA rounding (``ops.geometry.pairwise_sq_dist``)."""
    r2 = float(np.float32(radius * radius))  # the float32 constant XLA compares with
    support = points[:count]
    out = [(pairwise_sq_dist(support[c0:c0 + chunk], support) <= r2).sum(dim=1)
           for c0 in range(0, count, chunk)]
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.int64)


def calibrate_neighbor_limits(clouds: List[np.ndarray], spec: PyramidConfig,
                              keep_ratio: float = 0.8, sample_threshold: int = 2000,
                              device=None) -> Tuple[int, ...]:
    """Per-level neighbour limits covering ``keep_ratio`` of the
    neighbourhoods of the sample clouds (``limit_from_counts``); stops once
    every level has more than ``sample_threshold`` samples."""
    dev = resolve_device(device)
    hists = [[] for _ in range(spec.num_stages)]
    samples = [0] * spec.num_stages
    for cloud in clouds:
        cap0 = spec.caps[0]
        pts = np.full((1, cap0, 3), 1e9, np.float32)
        n = min(len(cloud), cap0)
        pts[0, :n] = cloud[:n]
        p = torch.from_numpy(pts).to(dev)
        c = torch.tensor([n], dtype=torch.int32, device=dev)
        voxel, radius = spec.voxel_size, spec.search_radius
        for lvl in range(spec.num_stages):
            if lvl > 0:
                voxel *= 2
                p, c, _ = grid_subsample(p, c, voxel, spec.caps[lvl])
            counts = _neighbor_counts(p[0], int(c[0]), radius)
            hists[lvl].append(counts)
            samples[lvl] += len(counts)
            radius *= 2
        if min(samples) > sample_threshold:
            break
    return tuple(limit_from_counts(np.concatenate(hists[lvl]), keep_ratio)
                 for lvl in range(spec.num_stages))


def limit_from_counts(counts: np.ndarray, keep_ratio: float) -> int:
    """The reference's rule: the number of count bins whose cumulative
    histogram stays strictly below ``keep_ratio * N``, i.e. the smallest K
    with #{c <= K} >= keep_ratio * N."""
    cum = np.cumsum(np.bincount(np.asarray(counts, np.int64)))
    return int(np.sum(cum < keep_ratio * len(counts)))


def calibrate_band_caps(clouds: List[np.ndarray], spec: PyramidConfig, headroom: float = 1.35,
                        multiple: int = 128, device=None) -> Tuple:
    """Per-level band capacities of the banded radius search: the largest
    chunk window over every search the pyramid makes (self, subsampling and
    the upsampling tables it builds) on the sample clouds, times
    ``headroom``, rounded up to ``multiple``; ``None`` where the band would
    not beat the whole level."""
    dev = resolve_device(device)
    max_band = [0] * spec.num_stages

    def sort_xmajor(p, cell):
        # the runtime's own key, so the measured occupancy bounds the runtime's
        t = torch.from_numpy(p).to(dev)[None]
        key, _ = voxel_sort_key(t, torch.ones(t.shape[:2], dtype=torch.bool, device=dev), cell)
        return p[np.argsort(key[0].cpu().numpy(), kind="stable")]

    def band_max(q, s, s_lvl, r, q_lvl):
        cell = spec.sort_cell(s_lvl)
        s_cells = np.floor(s[:, 0] / cell).astype(np.int64)
        q_cells = np.floor(q[:, 0] / cell).astype(np.int64)
        margin = band_margin(r, cell)
        chunk = spec.band_chunk_for(q_lvl)
        worst = 0
        for i in range(0, len(q), chunk):
            qc = q_cells[i:i + chunk]
            a = np.searchsorted(s_cells, qc.min() - margin, "left")
            b = np.searchsorted(s_cells, qc.max() + margin, "right")
            worst = max(worst, b - a)
        return worst

    for cloud in clouds:
        levels = [sort_xmajor(cloud[:spec.caps[0]].astype(np.float32), spec.sort_cell(0))]
        voxel = spec.voxel_size
        for lvl in range(1, spec.num_stages):
            voxel *= 2.0
            prev = torch.from_numpy(levels[-1]).to(dev)[None]
            count = torch.tensor([len(levels[-1])], dtype=torch.int32, device=dev)
            p, c, _ = grid_subsample(prev, count, voxel, spec.caps[lvl])
            levels.append(p[0, :int(c[0])].cpu().numpy())

        radius = spec.search_radius
        for lvl in range(spec.num_stages):
            m = band_max(levels[lvl], levels[lvl], lvl, radius, lvl)
            if lvl < spec.num_stages - 1:
                m = max(m, band_max(levels[lvl + 1], levels[lvl], lvl, radius, lvl + 1))
            if lvl >= 1 and lvl - 1 >= spec.build_upsampling_from_level:
                # upsampling[lvl-1]: level lvl-1 queries into level lvl, at
                # twice the previous level's radius, which is this level's
                m = max(m, band_max(levels[lvl - 1], levels[lvl], lvl, radius, lvl - 1))
            max_band[lvl] = max(max_band[lvl], m)
            radius *= 2.0

    caps = []
    for lvl in range(spec.num_stages):
        cap = -(-int(max_band[lvl] * headroom) // multiple) * multiple
        caps.append(None if cap >= spec.caps[lvl] else cap)
    return tuple(caps)
