"""Ground-truth correspondences on the device and the correspondence toolkit
(twin of ``rdmnet_tpu/ops/correspondences.py``).

The three functions the model and the losses call:

* ``node_correspondence_overlaps``: the dense (M, N) patch-overlap matrix;
* ``mutual_nearest_node_masks``: mutual-nearest node masks for the vote loss;
* ``radius_correspondence_masks``: per-point "has a partner within radius"
  labels of the overlap losses.

Their outputs are labels: nothing there carries a gradient, and inputs are
detached. The toolkit after them (score- and feature-based selection,
dense <-> node conversions, per-node overlap and occlusion ratios) is
library surface no model path calls. Every selection is a dense boolean
mask or a fixed-capacity set with a validity mask, whose True set is the
reference's ``nonzero`` list. Labels are decided on the exact distances of
``ops/geometry`` (XLA's float32 rounding), so they equal the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.ops.geometry import apply_transform, pairwise_sq_dist
from benchmark.reference.ops.select import top_k

BIG = 1.0e12


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 threshold on ``like``'s device, as JAX rounds a Python float."""
    # filled on the device: torch.tensor(value, device=cuda) copies from host memory
    return torch.full((), value, dtype=torch.float32, device=like.device)


@torch.no_grad()
def node_correspondence_overlaps(ref_nodes: torch.Tensor, src_nodes: torch.Tensor,
                                 ref_knn_points: torch.Tensor, src_knn_points: torch.Tensor,
                                 transform: torch.Tensor, pos_radius: float,
                                 ref_masks: torch.Tensor, src_masks: torch.Tensor,
                                 ref_knn_masks: torch.Tensor, src_knn_masks: torch.Tensor,
                                 num_candidates: int = 3072, chunk: int = 256) -> torch.Tensor:
    """Dense ground-truth patch overlaps (M, N).

    overlap(i, j) is the mean of the fraction of patch i's points with a
    point of patch j within ``pos_radius`` and the converse, computed for the
    ``num_candidates`` node pairs whose enclosing spheres overlap most (by
    margin). The JAX package selects them with ``approx_max_k`` above M*N =
    num_candidates on the TPU (exact on the CPU); the port's top-k is exact.
    """
    m, k, _ = ref_knn_points.shape
    n = src_nodes.shape[0]
    src_nodes_t = apply_transform(src_nodes, transform)
    src_knn_t = apply_transform(src_knn_points.reshape(-1, 3), transform).reshape(n, k, 3)

    zero = torch.zeros((), dtype=ref_knn_points.dtype, device=ref_knn_points.device)
    ref_d = torch.linalg.norm(ref_knn_points - ref_nodes[:, None, :], dim=-1)
    ref_rmax = torch.where(ref_knn_masks, ref_d, zero).amax(dim=1)
    src_d = torch.linalg.norm(src_knn_t - src_nodes_t[:, None, :], dim=-1)
    src_rmax = torch.where(src_knn_masks, src_d, zero).amax(dim=1)

    node_dist = torch.sqrt(pairwise_sq_dist(ref_nodes, src_nodes_t))
    margin = ref_rmax[:, None] + src_rmax[None, :] + pos_radius - node_dist
    pair_mask = (margin > 0) & ref_masks[:, None] & src_masks[None, :]

    num_candidates = min(num_candidates, m * n)
    flat = torch.where(pair_mask, margin, torch.full_like(margin, -BIG)).reshape(-1)
    top_vals, cand = top_k(flat, num_candidates)
    cand_valid = top_vals > -BIG / 2
    cand_ref = torch.div(cand, n, rounding_mode="floor")
    cand_src = cand % n

    r2 = _f32(pos_radius ** 2, ref_knn_points)
    overlaps = []
    for start in range(0, num_candidates, chunk):
        ri, si = cand_ref[start:start + chunk], cand_src[start:start + chunk]
        rm, sm = ref_knn_masks[ri], src_knn_masks[si]                   # (C, K)
        d2 = pairwise_sq_dist(ref_knn_points[ri], src_knn_t[si])        # (C, K, K)
        hit = (d2 < r2) & rm[:, :, None] & sm[:, None, :]
        ref_ov = hit.any(dim=2).sum(dim=1).float() / torch.clamp_min(rm.sum(dim=1).float(), 1.0)
        src_ov = hit.any(dim=1).sum(dim=1).float() / torch.clamp_min(sm.sum(dim=1).float(), 1.0)
        overlaps.append(0.5 * (ref_ov + src_ov))
    overlaps = torch.where(cand_valid, torch.cat(overlaps), zero)

    dense = torch.zeros((m, n), dtype=torch.float32, device=ref_nodes.device)
    dense[cand_ref, cand_src] = overlaps  # candidates are distinct pairs
    return dense


@torch.no_grad()
def mutual_nearest_node_masks(ref_nodes: torch.Tensor, src_nodes: torch.Tensor,
                              transform: torch.Tensor, pos_radius: float,
                              ref_masks: torch.Tensor, src_masks: torch.Tensor) -> torch.Tensor:
    """(M, N) bool: each side's nearest valid node of the other side, if
    within ``pos_radius``. The reference compares the SQUARED distance with
    the unsquared radius; reproduced, so the vote loss sees its labels."""
    m, n = ref_nodes.shape[0], src_nodes.shape[0]
    dev = ref_nodes.device
    sq = pairwise_sq_dist(ref_nodes, apply_transform(src_nodes, transform))
    sq = torch.where(ref_masks[:, None] & src_masks[None, :], sq, torch.full_like(sq, BIG))
    radius = _f32(pos_radius, sq)

    masks = torch.zeros((m, n), dtype=torch.bool, device=dev)
    rows, cols = torch.arange(m, device=dev), torch.arange(n, device=dev)
    ref_arg = torch.argmin(sq, dim=1)   # first minimum, as jnp.argmin
    masks[rows, ref_arg] = sq.amin(dim=1) < radius
    src_arg = torch.argmin(sq, dim=0)
    masks[src_arg, cols] = masks[src_arg, cols] | (sq.amin(dim=0) < radius)
    return masks & ref_masks[:, None] & src_masks[None, :]


@torch.no_grad()
def radius_correspondence_masks(ref_points: torch.Tensor, src_points_t: torch.Tensor,
                                ref_mask: torch.Tensor, src_mask: torch.Tensor, radius: float,
                                chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point overlap labels: True iff a valid point of the other (already
    transformed) cloud lies within ``radius``. Queries run in chunks of
    ``chunk`` rows: a dense level-1 block at the 0.7 bucket (8704 x 8704) would
    be 300 MB in float32 and several times that in the exact distances'
    float64 temporaries."""

    def chunked_min(q, s, s_valid):
        mins = []
        for start in range(0, q.shape[0], chunk):
            d2 = pairwise_sq_dist(q[start:start + chunk], s)
            mins.append(torch.where(s_valid[None, :], d2, torch.full_like(d2, BIG)).amin(dim=1))
        return torch.cat(mins)

    r2 = _f32(radius * radius, ref_points)
    ref_min = chunked_min(ref_points, src_points_t, src_mask)
    src_min = chunked_min(src_points_t, ref_points, ref_mask)
    return (ref_min < r2) & ref_mask, (src_min < r2) & src_mask


# --------------------------------------------------------------------------
# Correspondence toolkit. Scatters with the JAX package's mode="drop" route
# the dropped rows to a dump row or slot that is cut off afterwards (torch
# raises on an out-of-range index); jnp.take(mode="clip") is a clamp.
# --------------------------------------------------------------------------


def _dump(idx: torch.Tensor, size: int) -> torch.Tensor:
    """``idx`` with every entry outside [0, size) moved to ``size``."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < size), idx, torch.full_like(idx, size))


def _clip(idx: torch.Tensor, size: int) -> torch.Tensor:
    return torch.clamp(idx.long(), 0, size - 1)


def _take_fill(x: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """``x[idx]`` (int64), ``fill`` where ``idx`` is out of range."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < x.shape[0])
    return torch.where(ok, x[_clip(idx, x.shape[0])].long(), torch.full_like(idx, fill))


def correspondence_masks_from_scores(score_mat: torch.Tensor, mutual: bool = False,
                                     bilateral: bool = False, has_dustbin: bool = False,
                                     threshold: float = 0.0) -> torch.Tensor:
    """(N, M) bool selection from log matching probabilities: each row's
    argmax column where exp(score) > threshold; ``mutual`` intersects with the
    columns' argmax rows, ``bilateral`` unites with them. argmax returns the
    first maximum in both libraries."""
    probs = torch.exp(score_mat)
    n, m = probs.shape
    dev = probs.device
    thr = _f32(threshold, probs)
    row_sel = torch.zeros((n, m), dtype=torch.bool, device=dev)
    row_sel[torch.arange(n, device=dev), torch.argmax(probs, dim=1)] = probs.amax(dim=1) > thr
    mask = row_sel
    if mutual or bilateral:
        col_sel = torch.zeros((n, m), dtype=torch.bool, device=dev)
        col_sel[torch.argmax(probs, dim=0), torch.arange(m, device=dev)] = probs.amax(dim=0) > thr
        mask = (row_sel & col_sel) if mutual else (row_sel | col_sel)
    return mask[:-1, :-1] if has_dustbin else mask


def correspondence_masks_threshold(score_mat: torch.Tensor, threshold: float,
                                   has_dustbin: bool = False) -> torch.Tensor:
    """(N, M) bool: exp(score) > threshold."""
    probs = torch.exp(score_mat)
    if has_dustbin:
        probs = probs[:-1, :-1]
    return probs > _f32(threshold, probs)


def top_k_correspondences(score_mat: torch.Tensor, k: int, has_dustbin: bool = False,
                          largest: bool = True) -> Tuple[torch.Tensor, ...]:
    """The global top-k cells of the score matrix as a fixed-capacity set:
    (k,) ref indices, (k,) src indices, (k,) valid, (k,) scores. Equal scores
    keep the lower flat index first, as ``lax.top_k``; dustbin hits stay in
    the set with ``valid=False``."""
    n, m = score_mat.shape
    flat = score_mat.reshape(-1)
    _, idx = top_k(flat if largest else -flat, k)
    ref_idx = torch.div(idx, m, rounding_mode="floor").to(torch.int32)
    src_idx = (idx % m).to(torch.int32)
    valid = torch.ones((k,), dtype=torch.bool, device=score_mat.device)
    if has_dustbin:
        valid = (ref_idx != n - 1) & (src_idx != m - 1)
    return ref_idx, src_idx, valid, flat[idx]


def correspondence_masks_from_feats(ref_feats: torch.Tensor, src_feats: torch.Tensor,
                                    mutual: bool = False, bilateral: bool = False
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour feature matching: the (N, M) selection mask and the
    squared feature distances. exp(-d^2) > 0 keeps every row/column argmax."""
    sq = pairwise_sq_dist(ref_feats, src_feats)
    mask = correspondence_masks_from_scores(-sq, mutual=mutual, bilateral=bilateral,
                                            has_dustbin=False, threshold=0.0)
    return mask, sq


def nearest_node_assignment(points: torch.Tensor, nodes: torch.Tensor,
                            point_masks: Optional[torch.Tensor] = None,
                            node_masks: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's nearest valid node (int32; the sentinel ``len(nodes)`` for
    pad points) and each node's point count (int32)."""
    m = nodes.shape[0]
    sq = pairwise_sq_dist(points, nodes)
    if node_masks is not None:
        sq = torch.where(node_masks[None, :], sq, torch.full_like(sq, BIG))
    idx = torch.argmin(sq, dim=1)
    if point_masks is not None:
        idx = torch.where(point_masks, idx, torch.full_like(idx, m))
    sizes = torch.bincount(_dump(idx, m), minlength=m + 1)[:m]
    return idx.to(torch.int32), sizes.to(torch.int32)


def dense_to_node_correspondences(ref_points: torch.Tensor, src_points: torch.Tensor,
                                  ref_nodes: torch.Tensor, src_nodes: torch.Tensor,
                                  corr_indices: torch.Tensor,
                                  corr_mask: Optional[torch.Tensor] = None,
                                  ref_point_masks: Optional[torch.Tensor] = None,
                                  src_point_masks: Optional[torch.Tensor] = None,
                                  ref_node_masks: Optional[torch.Tensor] = None,
                                  src_node_masks: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point correspondences (C, 2) [ref, src] -> the dense (M, N) count of
    correspondences between the points' nearest nodes, and the proxy overlap
    score (c / |patch_i| + c / |patch_j|) / 2. Rows whose point index or
    node is out of range (padding) count nowhere."""
    ref_p2n, ref_sizes = nearest_node_assignment(ref_points, ref_nodes, ref_point_masks,
                                                 ref_node_masks)
    src_p2n, src_sizes = nearest_node_assignment(src_points, src_nodes, src_point_masks,
                                                 src_node_masks)
    m, n = ref_nodes.shape[0], src_nodes.shape[0]
    dev = ref_points.device
    weights = (corr_mask.to(torch.int32) if corr_mask is not None
               else torch.ones((corr_indices.shape[0],), dtype=torch.int32, device=dev))
    # jnp.take(mode="fill"): an out-of-range point index gives node m (n),
    # the dump row (column) of the count buffer
    ri = _take_fill(ref_p2n, corr_indices[:, 0], m)
    si = _take_fill(src_p2n, corr_indices[:, 1], n)
    counts = torch.zeros((m + 1, n + 1), dtype=torch.int32, device=dev)
    counts.index_put_((ri, si), weights, accumulate=True)
    counts = counts[:m, :n]
    cf = counts.float()
    scores = 0.5 * (cf / torch.clamp_min(ref_sizes, 1)[:, None].float()
                    + cf / torch.clamp_min(src_sizes, 1)[None, :].float())
    return counts, scores


def node_to_dense_correspondences(ref_knn_points: torch.Tensor, src_knn_points: torch.Tensor,
                                  ref_knn_indices: torch.Tensor, src_knn_indices: torch.Tensor,
                                  node_corr_indices: torch.Tensor, transform: torch.Tensor,
                                  matching_radius: float,
                                  node_corr_mask: Optional[torch.Tensor] = None,
                                  ref_knn_masks: Optional[torch.Tensor] = None,
                                  src_knn_masks: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """Node correspondences (P, 2) -> ``(corr (P, K, K) bool, ref_idx (P, K),
    src_idx (P, K), dist (P, K, K))``; the reference's (C, 2) list is
    ``{(ref_idx[p, i], src_idx[p, j]) : corr[p, i, j]}``. Node indices out of
    range are clipped, as ``jnp.take(mode="clip")``."""
    src_t = apply_transform(src_knn_points.reshape(-1, 3), transform).reshape(src_knn_points.shape)
    ri = _clip(node_corr_indices[:, 0], ref_knn_points.shape[0])
    si = _clip(node_corr_indices[:, 1], src_knn_points.shape[0])
    dist = torch.sqrt(pairwise_sq_dist(ref_knn_points[ri], src_t[si]))    # (P, K, K)
    corr = dist < _f32(matching_radius, dist)
    if ref_knn_masks is not None:
        corr = corr & ref_knn_masks[ri][:, :, None]
    if src_knn_masks is not None:
        corr = corr & src_knn_masks[si][:, None, :]
    if node_corr_mask is not None:
        corr = corr & node_corr_mask[:, None, None]
    return corr, ref_knn_indices[ri], src_knn_indices[si], dist


def node_pair_overlaps(ref_knn_points: torch.Tensor, src_knn_points: torch.Tensor,
                       transform: torch.Tensor, pos_radius: float,
                       ref_knn_masks: Optional[torch.Tensor] = None,
                       src_knn_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) symmetric overlap of aligned patch pairs: the mean of the two
    sides' fractions of points with a partner within ``pos_radius``."""
    src_t = apply_transform(src_knn_points.reshape(-1, 3), transform).reshape(src_knn_points.shape)
    dev = ref_knn_points.device
    if ref_knn_masks is None:
        ref_knn_masks = torch.ones(ref_knn_points.shape[:2], dtype=torch.bool, device=dev)
    if src_knn_masks is None:
        src_knn_masks = torch.ones(src_knn_points.shape[:2], dtype=torch.bool, device=dev)
    sq = pairwise_sq_dist(ref_knn_points, src_t)                          # (B, K, K)
    hit = ((sq < _f32(pos_radius ** 2, sq)) & ref_knn_masks[:, :, None]
           & src_knn_masks[:, None, :])
    ref_ov = hit.any(dim=2).float().sum(dim=1) / ref_knn_masks.float().sum(dim=1)
    src_ov = hit.any(dim=1).float().sum(dim=1) / src_knn_masks.float().sum(dim=1)
    return 0.5 * (ref_ov + src_ov)


def node_overlap_ratios(num_ref_points: int, num_src_points: int,
                        ref_knn_points: torch.Tensor, src_knn_points: torch.Tensor,
                        ref_knn_indices: torch.Tensor, src_knn_indices: torch.Tensor,
                        node_corr_indices: torch.Tensor, transform: torch.Tensor,
                        matching_radius: float, ref_knn_masks: torch.Tensor,
                        src_knn_masks: torch.Tensor,
                        node_corr_mask: Optional[torch.Tensor] = None,
                        eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per node, the fraction of its patch's points that take part in any
    dense ground-truth correspondence.

    The reference passes ``ref_knn_masks`` for BOTH sides when it builds the
    dense correspondences (matching.py:603-613); reproduced, so the ratios
    match it exactly."""
    corr, ref_idx, src_idx, _ = node_to_dense_correspondences(
        ref_knn_points, src_knn_points, ref_knn_indices, src_knn_indices, node_corr_indices,
        transform, matching_radius, node_corr_mask=node_corr_mask,
        ref_knn_masks=ref_knn_masks,
        src_knn_masks=ref_knn_masks)  # sic — reference matching.py:611

    def flags(num_points, idx, hit):
        # .at[idx].max(mode="drop") over num_points + 1 slots (the last is the
        # sentinel's), out-of-range rows into one more slot that is cut off
        buf = torch.zeros((num_points + 2,), dtype=torch.float32, device=hit.device)
        buf.scatter_reduce_(0, _dump(idx.reshape(-1), num_points + 1),
                            hit.reshape(-1).float(), reduce="amax", include_self=True)
        return buf[:num_points + 1]

    ref_flags = flags(num_ref_points, ref_idx, corr.any(dim=2))
    src_flags = flags(num_src_points, src_idx, corr.any(dim=1))
    ref_knn_flags = ref_flags[_clip(ref_knn_indices, num_ref_points + 1)]
    src_knn_flags = src_flags[_clip(src_knn_indices, num_src_points + 1)]
    rkm, skm = ref_knn_masks.float(), src_knn_masks.float()
    ref_ratios = (ref_knn_flags * rkm).sum(dim=1) / (rkm.sum(dim=1) + eps)
    src_ratios = (src_knn_flags * skm).sum(dim=1) / (skm.sum(dim=1) + eps)
    return ref_ratios, src_ratios


def node_occlusion_ratios(*args, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """1 - ``node_overlap_ratios``."""
    ref_ratios, src_ratios = node_overlap_ratios(*args, **kwargs)
    return 1.0 - ref_ratios, 1.0 - src_ratios
