"""Evaluation metrics PIR, IR, RRE, RTE and RR
(twin of ``rdmnet_tpu/losses/evaluator.py``)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.config import Config
from benchmark.reference.graph.pyramid import PairBatch
from benchmark.reference.ops.geometry import (
    apply_transform,
    dot3,
    get_rotation_translation_from_transform,
    masked_mean,
)


def relative_rotation_error(gt_rotations: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """RRE in degrees by the trace formula. The trace's entries take XLA's
    fused rounding (``dot3``), as the JAX package's matmul does: near 0
    degrees one ulp of the trace moves the angle by ~0.02 degrees."""
    diag = [dot3(rotations[..., :, i], gt_rotations[..., :, i]) for i in range(3)]
    trace = diag[0] + diag[1] + diag[2]
    x = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    return 180.0 * torch.arccos(x) / math.pi


def relative_translation_error(gt_translations: torch.Tensor,
                               translations: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(gt_translations - translations, dim=-1)


def isotropic_transform_error(gt_transforms: torch.Tensor, transforms: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    gt_r, gt_t = get_rotation_translation_from_transform(gt_transforms)
    r, t = get_rotation_translation_from_transform(transforms)
    return relative_rotation_error(gt_r, r), relative_translation_error(gt_t, t)


class Evaluator:
    def __init__(self, cfg: Config):
        self.acceptance_overlap = cfg.eval.acceptance_overlap
        self.acceptance_radius = cfg.eval.acceptance_radius
        self.rre_threshold = cfg.eval.rre_threshold
        self.rte_threshold = cfg.eval.rte_threshold

    def evaluate_coarse(self, out: Dict) -> torch.Tensor:
        """PIR: the share of predicted node correspondences that are true."""
        gt_map = out["gt_node_corr_overlaps"] > self.acceptance_overlap
        hits = gt_map[out["ref_node_corr_indices"].long(), out["src_node_corr_indices"].long()]
        return masked_mean(hits.float(), out["node_corr_valid"])

    def evaluate_fine(self, out: Dict, batch: PairBatch) -> torch.Tensor:
        """IR: the inlier ratio of the final dense correspondences."""
        src_corr = apply_transform(out["src_corr_points"], batch.transform)
        dist = torch.linalg.norm(out["ref_corr_points"] - src_corr, dim=1)
        return masked_mean((dist < self.acceptance_radius).float(), out["corr_scores"] > 0)

    def evaluate_registration(self, out: Dict, batch: PairBatch):
        rre, rte = isotropic_transform_error(batch.transform, out["estimated_transform"])
        recall = ((rre < self.rre_threshold) & (rte < self.rte_threshold)).float()
        return rre, rte, recall

    def __call__(self, out: Dict, batch: PairBatch, evaling: bool = True) -> Dict[str, torch.Tensor]:
        result = {"PIR": self.evaluate_coarse(out)}
        if evaling and "estimated_transform" in out:
            rre, rte, recall = self.evaluate_registration(out, batch)
            result.update({"IR": self.evaluate_fine(out, batch), "RRE": rre, "RTE": rte,
                           "RR": recall})
        return result
