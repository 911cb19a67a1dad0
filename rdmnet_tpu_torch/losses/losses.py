"""RDMNet training losses (twin of ``rdmnet_tpu/losses/losses.py``).

Masked, static-shape terms over one pair's output dict: ground-truth labels
come from the exact distances of ``ops/correspondences`` and
``ops/geometry``, so they equal the JAX package's, and every reduction skips
pads. The losses hold no parameters.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rdmnet_tpu_torch.config import Config
from rdmnet_tpu_torch.graph.pyramid import PairBatch
from rdmnet_tpu_torch.losses.circle_loss import weighted_circle_loss
from rdmnet_tpu_torch.ops.correspondences import radius_correspondence_masks
from rdmnet_tpu_torch.ops.geometry import apply_transform, masked_mean, pairwise_sq_dist

BIG = 1.0e12
# sqrt(0) has an infinite gradient: every loss-side sqrt is guarded, so exact
# zero distances (perfect matches) cannot NaN the backward pass
SQRT_EPS = 1e-12


def _weighted_bce(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """Class-balanced binary cross-entropy over the valid entries."""
    v = valid.to(pred.dtype)
    n = torch.clamp_min(v.sum(), 1.0)
    w_neg = (gt * v).sum() / n
    w_pos = 1.0 - w_neg
    pred = torch.clamp(pred, eps, 1.0 - eps)
    bce = -(gt * torch.log(pred) + (1.0 - gt) * torch.log(1.0 - pred))
    weights = torch.where(gt >= 0.5, w_pos, w_neg)
    return (weights * bce * v).sum() / n


class CoarseMatchingLoss:
    """Weighted circle loss on node feature distances. Every surviving node
    takes part, also one that owns no fine point (its overlap row is 0, all
    negatives): pairs are valid by the NMS survivor masks."""

    def __init__(self, cfg: Config):
        self.cfg = cfg.coarse_loss

    def __call__(self, out: Dict) -> torch.Tensor:
        overlaps = out["gt_node_corr_overlaps"]
        pair_valid = out["nodes_ref_valid"][:, None] & out["nodes_src_valid"][None, :]
        feat_dists = torch.sqrt(pairwise_sq_dist(out["ref_feats_c"], out["src_feats_c"],
                                                 normalized=True) + SQRT_EPS)
        pos_masks = overlaps > self.cfg.positive_overlap
        neg_masks = overlaps == 0.0
        pos_scales = torch.sqrt(overlaps * pos_masks.to(overlaps.dtype))
        c = self.cfg
        return weighted_circle_loss(pos_masks, neg_masks, feat_dists, c.positive_margin,
                                    c.negative_margin, c.positive_optimal, c.negative_optimal,
                                    c.log_scale, pair_valid=pair_valid, pos_scales=pos_scales)


class GapLoss:
    """Score-gap hinge on the transport plan, both sides."""

    def __init__(self, cfg: Config):
        self.positive_radius = cfg.gap_loss.positive_radius
        self.gamma = cfg.gap_loss.triplet_loss_gamma

    def __call__(self, out: Dict, batch: PairBatch) -> torch.Tensor:
        ref_pts = out["ref_node_corr_knn_points"]   # (P, K, 3)
        ref_m = out["ref_node_corr_knn_masks"]      # (P, K)
        src_m = out["src_node_corr_knn_masks"]
        scores = out["matching_scores"]             # (P, K+1, K+1)
        p, k1, _ = scores.shape
        k = k1 - 1
        dev = scores.device
        src_pts = apply_transform(out["src_node_corr_knn_points"], batch.transform)
        dists = pairwise_sq_dist(ref_pts, src_pts)  # (P, K, K) squared
        r2 = torch.tensor(self.positive_radius ** 2, dtype=torch.float32, device=dev)
        big = torch.full_like(dists, BIG)
        kk = torch.full((p, k), k, dtype=torch.int64, device=dev)

        # ref side: one label per row of the plan. The reference's pad slots
        # are zero rows, so a pad is the (transformed) origin; the port's pads
        # sit far away, and each pad slot takes its distance to the origin.
        t = batch.transform[:3, 3]
        ref_to_padsq = ((ref_pts - t) ** 2).sum(dim=-1)   # ref_i to the transformed src pad
        src_to_padsq = (src_pts ** 2).sum(dim=-1)         # src_j to the zero ref pad
        d_emul = torch.where(src_m[:, None, :], dists, ref_to_padsq[:, :, None])
        d_emul = torch.where(ref_m[:, :, None], d_emul, big)
        ref_min, ref_arg = d_emul.amin(dim=2), torch.argmin(d_emul, dim=2)
        arg_real = torch.gather(src_m, 1, ref_arg)
        ref_label = torch.where((ref_min < r2) & arg_real, ref_arg, kk)    # (P, K) in [0, K]
        ref_rows = scores[:, :k, :]                                        # (P, K, K+1)
        pos = -torch.gather(ref_rows, 2, ref_label[..., None])[..., 0]
        onehot = torch.nn.functional.one_hot(ref_label, k1).bool()
        neg_all = torch.where(onehot, torch.full_like(ref_rows, float("inf")), -ref_rows)
        neg = -torch.sort(-neg_all, dim=2, stable=True).values[:, :, 1:]   # the label dropped
        hinge = torch.clamp_min(pos[..., None] - neg + self.gamma, 0.0)
        loss_ref = masked_mean(torch.log(hinge.sum(dim=2) + 1.0), ref_m)

        # src side: the reference gathers the non-label entries of the
        # (K+1, K) grid in ROW-MAJOR order and reshapes them to (K, K), though
        # its labels are one per column, which scrambles negatives across
        # columns. Kept: the published model was trained with exactly this.
        # A stable argsort of the label flags is "flatten, drop the labels".
        d_emul_t = dists.transpose(1, 2)                                   # (P, K_src, K_ref)
        d_emul_t = torch.where(ref_m[:, None, :], d_emul_t, src_to_padsq[:, :, None])
        d_emul_t = torch.where(src_m[:, :, None], d_emul_t, big)
        src_min, src_arg = d_emul_t.amin(dim=2), torch.argmin(d_emul_t, dim=2)
        arg_real2 = torch.gather(ref_m, 1, src_arg)
        src_label = torch.where((src_min < r2) & arg_real2, src_arg, kk)
        grid = -scores[:, :, :k]                                           # (P, K+1, K)
        pos2 = torch.gather(grid, 1, src_label[:, None, :])[:, 0, :]       # (P, K)
        lab = torch.arange(k1, device=dev)[None, :, None] == src_label[:, None, :]
        order = torch.argsort(lab.reshape(p, k1 * k).to(torch.uint8), dim=1, stable=True)
        neg2 = torch.gather(grid.reshape(p, k1 * k), 1, order[:, :k * k]).reshape(p, k, k)
        # positives come out of the same row-major gather, ordered by
        # (label row, column): sequence position t meets negatives column t
        seq = src_label * k + torch.arange(k, device=dev)[None, :]
        perm = torch.argsort(seq, dim=1)                                   # distinct keys
        pos2_seq = torch.gather(pos2, 1, perm)
        col_valid_seq = torch.gather(src_m, 1, perm)
        hinge2 = torch.clamp_min(pos2_seq[:, None, :] - neg2 + self.gamma, 0.0)
        loss_src = masked_mean(torch.log(hinge2.sum(dim=1) + 1.0), col_valid_seq)
        return 0.5 * (loss_ref + loss_src)


class OverlapLoss:
    """n2p and p2p class-balanced BCE, labels from radius queries."""

    def __init__(self, cfg: Config):
        self.n2p_threshold = cfg.vote.n2p_overlap_threshold
        self.p2p_threshold = cfg.vote.p2p_overlap_threshold

    def __call__(self, out: Dict, batch: PairBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        tf = batch.transform
        ref_f, src_f = out["ref_points_f"], apply_transform(out["src_points_f"], tf)
        ref_fm, src_fm = out["ref_mask_f"], out["src_mask_f"]
        ref_c, src_c = out["ref_points_c"], apply_transform(out["src_points_c"], tf)
        ref_cm, src_cm = out["ref_mask_c"], out["src_mask_c"]

        # p2p: a fine point has a partner in the other cloud within radius
        ref_gt, src_gt = radius_correspondence_masks(ref_f, src_f, ref_fm, src_fm,
                                                     self.p2p_threshold)
        p2p_loss = _weighted_bce(torch.cat([out["src_p2p_scores_c"], out["ref_p2p_scores_c"]]),
                                 torch.cat([src_gt, ref_gt]).float(),
                                 torch.cat([src_fm, ref_fm]))
        # n2p: a node has a fine point of the other cloud within radius
        ref_n2p, _ = radius_correspondence_masks(ref_c, src_f, ref_cm, src_fm, self.n2p_threshold)
        src_n2p, _ = radius_correspondence_masks(src_c, ref_f, src_cm, ref_fm, self.n2p_threshold)
        n2p_loss = _weighted_bce(torch.cat([out["src_n2p_scores_c"], out["ref_n2p_scores_c"]]),
                                 torch.cat([src_n2p, ref_n2p]).float(),
                                 torch.cat([src_cm, ref_cm]))
        return n2p_loss, p2p_loss


class VoteLoss:
    """Masked chamfer between the shifted node sets, plus the n2n BCE."""

    def __init__(self, cfg: Config):
        self.n2n_threshold = cfg.vote.n2n_overlap_threshold

    def __call__(self, out: Dict, batch: PairBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        ref_node = out["shifted_ref_points_c"]
        src_node = apply_transform(out["shifted_src_points_c"], batch.transform)
        ref_vm, src_vm = out["ref_mask_c"], out["src_mask_c"]
        mask_mat = out["vote_mask_mat"]

        sq = pairwise_sq_dist(ref_node, src_node)
        sq = torch.where(ref_vm[:, None] & src_vm[None, :], sq, torch.full_like(sq, BIG))
        dist = torch.sqrt(sq + SQRT_EPS)
        chamfer = (masked_mean(dist.amin(dim=1), mask_mat.any(dim=1))
                   + masked_mean(dist.amin(dim=0), mask_mat.any(dim=0)))

        ref_gt, src_gt = radius_correspondence_masks(ref_node, src_node, ref_vm, src_vm,
                                                     self.n2n_threshold)
        n2n_loss = _weighted_bce(torch.cat([out["src_n2n_scores_c"], out["ref_n2n_scores_c"]]),
                                 torch.cat([src_gt, ref_gt]).float(),
                                 torch.cat([src_vm, ref_vm]))
        return chamfer, n2n_loss


class SingleSideChamferLoss:
    """Keep the shifted nodes near their own cloud."""

    def __call__(self, out: Dict) -> torch.Tensor:
        def side(nodes, node_m, points, point_m):
            sq = pairwise_sq_dist(nodes, points)
            sq = torch.where(point_m[None, :], sq, torch.full_like(sq, BIG))
            return masked_mean(torch.sqrt(sq.amin(dim=1) + SQRT_EPS), node_m)

        ref = side(out["shifted_ref_points_c"], out["ref_mask_c"],
                   out["ref_points_f"], out["ref_mask_f"])
        src = side(out["shifted_src_points_c"], out["src_mask_c"],
                   out["src_points_f"], out["src_mask_f"])
        return 0.5 * (ref + src)


class OverallLoss:
    """The weighted sum of the seven terms; without the vote layer
    (``model_use_vote=False``) the vote, n2n and node-on-cloud terms are
    left out."""

    def __init__(self, cfg: Config):
        self.weights = cfg.loss
        self.use_vote = cfg.vote.model_use_vote
        self.coarse_loss = CoarseMatchingLoss(cfg)
        self.gap_loss = GapLoss(cfg)
        self.overlap_loss = OverlapLoss(cfg)
        self.vote_loss = VoteLoss(cfg)
        self.node_on_pc_loss = SingleSideChamferLoss()

    def __call__(self, out: Dict, batch: PairBatch) -> Dict[str, torch.Tensor]:
        w = self.weights
        c_loss = self.coarse_loss(out)
        g_loss = self.gap_loss(out, batch)
        n_loss, p_loss = self.overlap_loss(out, batch)
        loss = w.weight_coarse_loss * c_loss + w.weight_gap_loss * g_loss + n_loss + p_loss
        result = {"c_loss": c_loss, "g_loss": g_loss, "n_loss": n_loss, "p_loss": p_loss}
        if self.use_vote:
            v_loss, nn_loss = self.vote_loss(out, batch)
            d_loss = self.node_on_pc_loss(out)
            loss = loss + (v_loss + d_loss) * w.weight_vote_loss + nn_loss
            result.update(v_loss=v_loss, nn_loss=nn_loss, d_loss=d_loss)
        result["loss"] = loss
        return result
