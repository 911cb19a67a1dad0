"""Point matching without LGR, and radius grouping
(twin of ``rdmnet_tpu/nn/point_matching.py``).

* ``point_matching``: correspondence extraction from per-patch log transport
  plans, LGR's first stage without the pose (library surface: the RDMNet
  forward does not call it);
* ``group_and_aggregate``: radius-group support points around each query
  and max-pool their features. The grouping is ``ops/radius_search.radius_knn``:
  the radius-kNN kernel for CUDA tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rdmnet_tpu_torch.config import FineMatchingConfig
from rdmnet_tpu_torch.ops.geometry import take_padded
from rdmnet_tpu_torch.ops.lgr import Correspondences, _extract_correspondences
from rdmnet_tpu_torch.ops.radius_search import radius_knn


def point_matching(ref_knn_points: torch.Tensor, src_knn_points: torch.Tensor,
                   ref_knn_masks: torch.Tensor, src_knn_masks: torch.Tensor,
                   matching_scores: torch.Tensor, corr_valid: torch.Tensor,
                   cfg: FineMatchingConfig) -> Correspondences:
    """Dense correspondences (row/column top-k against the dustbin) of the
    (P, K+1, K+1) log transport plans, without pose estimation."""
    corr, _ = _extract_correspondences(torch.exp(matching_scores), ref_knn_points,
                                       src_knn_points, ref_knn_masks, src_knn_masks,
                                       corr_valid, cfg)
    return corr


def group_and_aggregate(q_points: torch.Tensor, s_points: torch.Tensor, s_feats: torch.Tensor,
                        s_count: torch.Tensor, radius: float, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The up-to-``k`` nearest support rows within ``radius`` of each query,
    their features max-pooled: (q_feats (Q, C), group_sizes (Q,) int32); an
    empty group pools to 0. Any ``k``: above 256 the kernel takes its select
    path."""
    idx = radius_knn(q_points, s_points, s_count, radius, k)             # (Q, k)
    feats = take_padded(s_feats, idx, fill_value=float("-inf"))
    group_sizes = (idx < s_points.shape[0]).sum(dim=1).to(torch.int32)
    pooled = feats.amax(dim=1)
    pooled = torch.where(group_sizes[:, None] > 0, pooled, torch.zeros_like(pooled))
    return pooled, group_sizes
