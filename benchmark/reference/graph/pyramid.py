"""Multi-scale pyramid builder (twin of ``rdmnet_tpu/graph/pyramid.py``).

For each level: voxel subsample (voxel doubling per level) and three padded
index tables with sentinel padding (index == capacity of the indexed level):

* ``neighbors[i]``   — level-i points' radius neighbours within level i,
* ``subsampling[i]`` — level-(i+1) points' radius neighbours within level i,
* ``upsampling[i]``  — level-i points' radius*2 neighbours within level i+1.

The (ref, src) pair is built together as a batch of two clouds, as the JAX
package's pair ``vmap`` does: each of the 12 radius searches per cloud is one
kernel launch for both clouds.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch

from benchmark.reference.config import PyramidConfig
from benchmark.reference.ops.grid_subsample import PAD_COORD, grid_subsample, voxel_sort_key
from benchmark.reference.ops.radius_search import radius_knn, radius_knn_banded


@dataclasses.dataclass
class CloudPyramid:
    """Static-shape pyramid of one cloud (or, with a leading batch axis on
    every tensor, of a batch of clouds)."""

    points: Tuple[torch.Tensor, ...]       # level i: (cap_i, 3)
    counts: Tuple[torch.Tensor, ...]       # level i: () int32
    neighbors: Tuple[torch.Tensor, ...]    # level i: (cap_i, K_i) into level i
    subsampling: Tuple[torch.Tensor, ...]  # i: (cap_{i+1}, K_i) into level i
    upsampling: Tuple[torch.Tensor, ...]   # i: (cap_i, K_up) into level i+1
    dropped: torch.Tensor                  # (num_stages,) int32 overflow telemetry

    @property
    def num_stages(self) -> int:
        return len(self.points)

    def mask(self, level: int) -> torch.Tensor:
        cap = self.points[level].shape[-2]
        return torch.arange(cap, device=self.points[level].device) < self.counts[level][..., None]

    def select(self, b: int) -> "CloudPyramid":
        """Cloud ``b`` of a batched pyramid."""
        pick = lambda ts: tuple(t[b] for t in ts)  # noqa: E731
        return CloudPyramid(pick(self.points), pick(self.counts), pick(self.neighbors),
                            pick(self.subsampling), pick(self.upsampling), self.dropped[b])


@dataclasses.dataclass
class PairBatch:
    """One registration pair (ref, src) plus its transform, fully padded."""

    ref: CloudPyramid
    src: CloudPyramid
    ref_feats: torch.Tensor   # (cap_0, C_in)
    src_feats: torch.Tensor
    transform: torch.Tensor   # (4, 4) src -> ref


@dataclasses.dataclass
class StackedGraph:
    """The (ref, src) pair concatenated into one graph per level: src rows
    sit at an offset of cap per level, tables are offset/sentinel-remapped,
    so the backbone's GroupNorm statistics cover both clouds jointly."""

    points: Tuple[torch.Tensor, ...]       # level i: (2 cap_i, 3)
    masks: Tuple[torch.Tensor, ...]        # level i: (2 cap_i,) bool
    neighbors: Tuple[torch.Tensor, ...]
    subsampling: Tuple[torch.Tensor, ...]
    upsampling: Tuple[torch.Tensor, ...]
    counts: Tuple[torch.Tensor, ...]       # level i: (2,) int32 [ref, src]

    @property
    def num_stages(self) -> int:
        return len(self.points)

    def mask(self, level: int) -> torch.Tensor:
        return self.masks[level]

    def index_valid(self, level: int, idx: torch.Tensor) -> torch.Tensor:
        cap = self.points[level].shape[0] // 2
        cnt = self.counts[level]
        return torch.where(idx < cap, idx < cnt[0], idx - cap < cnt[1])


def stack_pair_graph(ref: CloudPyramid, src: CloudPyramid) -> StackedGraph:
    """Concatenate two same-capacity pyramids: ref sentinels C -> 2C, src
    entries shifted by +C (their sentinel lands on 2C)."""
    ns = ref.num_stages

    def remap(ref_tab, src_tab, s_cap):
        r = torch.where(ref_tab >= s_cap, torch.full_like(ref_tab, 2 * s_cap), ref_tab)
        return torch.cat([r, src_tab + s_cap], dim=0)

    caps = [ref.points[i].shape[0] for i in range(ns)]
    return StackedGraph(
        points=tuple(torch.cat([ref.points[i], src.points[i]]) for i in range(ns)),
        masks=tuple(torch.cat([ref.mask(i), src.mask(i)]) for i in range(ns)),
        neighbors=tuple(remap(ref.neighbors[i], src.neighbors[i], caps[i]) for i in range(ns)),
        subsampling=tuple(remap(ref.subsampling[i], src.subsampling[i], caps[i])
                          for i in range(ns - 1)),
        upsampling=tuple(remap(ref.upsampling[i], src.upsampling[i], caps[i + 1])
                         for i in range(ns - 1)),
        counts=tuple(torch.stack([ref.counts[i], src.counts[i]]) for i in range(ns)),
    )


class SearchSpec(NamedTuple):
    """One radius search of the graph build: ``table`` row ``q_lvl`` points
    against level ``s_lvl``; banded when ``band`` is set."""

    table: str
    q_lvl: int
    s_lvl: int
    radius: float
    k: int
    band: Optional[int]
    chunk: int
    cell: float


def search_plan(spec: PyramidConfig) -> List[SearchSpec]:
    """The radius searches of one pyramid, in build order: per level i the
    neighbours (i, i), the subsampling table (i+1 -> i) and, from
    ``build_upsampling_from_level``, the upsampling table (i -> i+1, twice
    the radius). Radius doubles per level. 12 searches at 5 levels."""
    plan = []

    def add(table, q_lvl, s_lvl, r, k):
        band = spec.band_caps[s_lvl]
        if band is not None and band >= spec.caps[s_lvl]:
            band = None
        plan.append(SearchSpec(table, q_lvl, s_lvl, r, k, band, spec.band_chunk_for(q_lvl),
                               spec.sort_cell(s_lvl)))

    radius = spec.search_radius
    for i in range(spec.num_stages):
        add("neighbors", i, i, radius, spec.neighbor_limits[i])
        if i < spec.num_stages - 1:
            add("subsampling", i + 1, i, radius, spec.neighbor_limits[i])
            if i >= spec.build_upsampling_from_level:
                add("upsampling", i, i + 1, radius * 2.0,
                    spec.upsampling_limit or spec.neighbor_limits[i + 1])
        radius *= 2.0
    return plan


def build_cloud_pyramid(points: torch.Tensor, count: torch.Tensor, spec: PyramidConfig,
                        dropped0=None, sp_group=None, sp_min_queries: int = 2048) -> CloudPyramid:
    """Build the pyramids of a batch of padded clouds.

    points (B, cap_0, 3) float32, count (B,) int32; dropped0 (B,) host
    truncation counts. Returns a CloudPyramid whose tensors carry the batch
    axis first.

    ``sp_group``: a process group whose ranks all build the same clouds; the
    searches whose query level holds ``sp_min_queries`` rows or more run
    query-sharded over it (``parallel.sharded_radius_knn``), the rest whole
    on every rank. The tables equal the unsharded build's.
    """
    bsz, n0, _ = points.shape
    assert n0 == spec.caps[0], f"level-0 capacity mismatch: {n0} vs {spec.caps[0]}"
    dev = points.device
    count = count.to(torch.int32)
    if dropped0 is None:
        dropped0 = torch.zeros(bsz, dtype=torch.int32, device=dev)

    # level 0 sorted by the x-major voxel key (stable, as lax.sort)
    valid0 = torch.arange(n0, device=dev)[None, :] < count[:, None]
    key, n_clipped0 = voxel_sort_key(points, valid0, spec.sort_cell(0))
    order = torch.sort(key, dim=1, stable=True).indices
    points = torch.gather(points, 1, order[..., None].expand(bsz, n0, 3))

    pts, cnts = [points], [count]
    drops = [dropped0.to(torch.int32) + n_clipped0]
    voxel = spec.voxel_size
    for i in range(1, spec.num_stages):
        voxel *= 2.0
        p, c, d = grid_subsample(pts[-1], cnts[-1], voxel, spec.caps[i])
        pts.append(p)
        cnts.append(c)
        drops.append(d)

    neighbors, subsampling, upsampling = [], [], []
    band_over = [torch.zeros(bsz, dtype=torch.int32, device=dev) for _ in range(spec.num_stages)]
    tables = {"neighbors": neighbors, "subsampling": subsampling, "upsampling": upsampling}
    for sp in search_plan(spec):
        if sp_group is not None and spec.caps[sp.q_lvl] >= sp_min_queries:
            from benchmark.reference.parallel.sharded_search import sharded_radius_knn

            out, ov = sharded_radius_knn(
                pts[sp.q_lvl], pts[sp.s_lvl], cnts[sp.s_lvl], sp.radius, sp.k, sp_group,
                q_count=cnts[sp.q_lvl], cell=sp.cell, band_cap=sp.band, chunk_size=sp.chunk,
                return_overflow=True)
            band_over[sp.s_lvl] = band_over[sp.s_lvl] + ov
        elif sp.band is None:
            out = radius_knn(pts[sp.q_lvl], pts[sp.s_lvl], cnts[sp.s_lvl], sp.radius, sp.k)
        else:
            out, ov = radius_knn_banded(
                pts[sp.q_lvl], pts[sp.s_lvl], cnts[sp.s_lvl], sp.radius, sp.k, cell=sp.cell,
                band_cap=sp.band, q_count=cnts[sp.q_lvl], chunk_size=sp.chunk)
            band_over[sp.s_lvl] = band_over[sp.s_lvl] + ov
        tables[sp.table].append(out)
        if sp.table == "subsampling" and sp.s_lvl < spec.build_upsampling_from_level:
            # unconsumed upsampling table: all-sentinel placeholder
            k_up = spec.upsampling_limit or spec.neighbor_limits[sp.s_lvl + 1]
            upsampling.append(torch.full((bsz, spec.caps[sp.s_lvl], k_up), spec.caps[sp.s_lvl + 1],
                                         dtype=torch.int32, device=dev))

    return CloudPyramid(
        points=tuple(pts),
        counts=tuple(cnts),
        neighbors=tuple(neighbors),
        subsampling=tuple(subsampling),
        upsampling=tuple(upsampling),
        dropped=torch.stack(drops, dim=1) + torch.stack(band_over, dim=1),
    )


def pad_cloud(points, cap: int, pad_coord: float = PAD_COORD, device=None):
    """Pad/truncate an (N, 3) cloud to (cap, 3) with far-away pad rows.
    Returns (padded (cap, 3) float32, count () int32)."""
    pts = torch.as_tensor(points, dtype=torch.float32, device=device)
    n = min(pts.shape[0], cap)
    out = torch.full((cap, 3), pad_coord, dtype=torch.float32, device=pts.device)
    out[:n] = pts[:n]
    return out, torch.tensor(n, dtype=torch.int32, device=pts.device)


def build_pair_batch(ref_points, ref_count, src_points, src_count, transform,
                     spec: PyramidConfig, input_dim: int = 1,
                     ref_dropped0=0, src_dropped0=0, sp_group=None,
                     sp_min_queries: int = 2048) -> PairBatch:
    """Build both pyramids of a registration pair in one batched pass.

    Input features are all-ones on valid rows, zero on pad rows.
    ``*_dropped0`` record host-side level-0 truncation: ints, or 0-d integer
    tensors on the clouds' device. With ``sp_group``
    (see ``build_cloud_pyramid``) the two clouds build one after the other,
    as the JAX package drops its pair ``vmap`` under a mesh.
    """
    dev = ref_points.device
    points = torch.stack([ref_points, src_points]).float()
    counts = torch.stack([torch.as_tensor(ref_count, device=dev),
                          torch.as_tensor(src_count, device=dev)]).to(torch.int32)
    # a host int is filled on the device (no copy from host memory, which a
    # CUDA graph refuses); a tensor is read where it lies, so it can be a
    # captured program's static input
    dropped0 = torch.stack([d.to(dev, torch.int32).reshape(()) if torch.is_tensor(d)
                            else torch.full((), int(d), dtype=torch.int32, device=dev)
                            for d in (ref_dropped0, src_dropped0)])
    if sp_group is None:
        both = build_cloud_pyramid(points, counts, spec, dropped0=dropped0)
        ref, src = both.select(0), both.select(1)
    else:
        ref, src = (build_cloud_pyramid(points[b:b + 1], counts[b:b + 1], spec,
                                        dropped0=dropped0[b:b + 1], sp_group=sp_group,
                                        sp_min_queries=sp_min_queries).select(0)
                    for b in range(2))
    cap0 = spec.caps[0]
    ar = torch.arange(cap0, device=dev)[:, None]
    ref_feats = (ar < ref_count).float().repeat(1, input_dim)
    src_feats = (ar < src_count).float().repeat(1, input_dim)
    return PairBatch(ref=ref, src=src, ref_feats=ref_feats,
                     src_feats=src_feats,
                     transform=torch.as_tensor(transform, dtype=torch.float32, device=dev))
