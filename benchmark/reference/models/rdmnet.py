"""RDMNet on one pair, the benchmark's frozen plain copy of the port's model.

Order: stacked-pair KPConv encoder -> ThDRoFormer #1 -> decoder -> vote,
NMS -> ThDRoFormer #2 -> point-to-node partition -> superpoint matching ->
patch Sinkhorn -> local-to-global registration. Every kernel of the port is
replaced by its plain version (``benchmark/reference/kernels.py``); only the
ThDRoFormer family is kept. The module is built on its device with no
initialisation of its own: the benchmark loads the weights it drew from the
seed. ``with_gt`` adds the ground-truth targets the losses read;
``training`` swaps the matched patches for sampled ground-truth ones, runs
Sinkhorn under autograd and skips registration. Submodules carry the port's
names, so the port's ``state_dict`` keys load here unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.config import Config
from benchmark.reference.device import resolve_device
from benchmark.reference.graph.pyramid import PairBatch, stack_pair_graph
from benchmark.reference.nn.backbone import Decoder, Encoder
from benchmark.reference.nn.matching import superpoint_matching, superpoint_target_sample
from benchmark.reference.nn.precision import compute_dtype
from benchmark.reference.nn.sinkhorn import LearnableLogOptimalTransport
from benchmark.reference.nn.thdroformer import ThDRoFormer
from benchmark.reference.nn.vote import VoteLayer
from benchmark.reference.ops.correspondences import (
    mutual_nearest_node_masks,
    node_correspondence_overlaps,
)
from benchmark.reference.ops.geometry import take_padded
from benchmark.reference.ops.lgr import local_to_global_registration
from benchmark.reference.ops.nms import greedy_nms
from benchmark.reference.ops.partition import point_to_node_partition

STAGES = ("build", "encoder+T1", "decoder", "vote/NMS/T2", "matching", "OT", "LGR")


def coarse_transformer(cfg: Config, stage: int) -> nn.Module:
    """The coarse transformer of ``stage`` (1: on the encoder's coarse
    features; 2: on the voted NMS survivors) for ``cfg.model.coarse_module``.
    Every family takes ``(ref_points, src_points, ref_feats, src_feats,
    ref_valid, src_valid)``; only ThDRoFormer takes ``cfg.compute_dtype``."""
    kind = cfg.model.coarse_module
    td = cfg.thdroformer
    in_dim = td.input_dim if stage == 1 else td.input_dim2
    layers = td.num_layers if stage == 1 else td.num_layers2
    if kind == "thdroformer":
        return ThDRoFormer(in_dim, td.output_dim, td.hidden_dim, td.num_heads, layers,
                           k=None if stage == 1 else td.k2,
                           dtype=compute_dtype(cfg.compute_dtype))
    raise ValueError(f"unknown coarse_module {kind!r}")


class RDMNet(nn.Module):
    def __init__(self, cfg: Config, device=None):
        super().__init__()
        dev = resolve_device(device)
        with torch.device(dev):
            self._build(cfg)
        self.to(dev)
        self.eval()

    def _build(self, cfg: Config) -> None:
        self.cfg = cfg
        out_dim = cfg.thdroformer.output_dim
        dtype = compute_dtype(cfg.compute_dtype)
        self.encoder = Encoder(cfg.backbone, dtype=dtype)
        self.transformer = coarse_transformer(cfg, 1)
        self.proj_n2p_score = nn.Linear(out_dim, 1)
        self.decoder = Decoder(cfg.backbone, dtype=dtype)
        if cfg.vote.model_use_vote:
            self.vote = VoteLayer(cfg.vote, out_dim)
            self.proj_n2n_score = nn.Linear(out_dim, 1)
            self.transformer2 = coarse_transformer(cfg, 2)
        self.optimal_transport = LearnableLogOptimalTransport(cfg.model.num_sinkhorn_iterations)

    @property
    def device(self) -> torch.device:
        return self.proj_n2p_score.weight.device

    def forward(self, batch: PairBatch, training: bool = False, with_gt: bool = False,
                generator: Optional[torch.Generator] = None,
                stage_hook: Optional[Callable[[str], None]] = None,
                node_corr: Optional[Tuple[torch.Tensor, ...]] = None) -> Dict[str, Any]:
        """One pair. Autograd stays on unless the caller turns it off
        (``pipeline`` runs inference under ``no_grad``).

        ``training`` needs ``with_gt`` and a ``generator`` on the batch's
        device for the target sample; it runs Sinkhorn's plain version under
        autograd (the CUDA kernel has no backward), inference the kernel.
        ``stage_hook(name)``, when given, is called after each stage of
        ``STAGES[1:]`` (timing breakdowns). ``node_corr`` (ref indices, src
        indices, scores, valid), when given, replaces the matched node pairs
        that the patches, optimal transport and LGR take (the outputs'
        ``node_corr_*`` stay the model's own): one device's run replayed on
        another's node pairs."""
        if training and (not with_gt or generator is None):
            raise ValueError("training=True needs with_gt=True and a generator")
        cfg = self.cfg
        mark = stage_hook or (lambda name: None)
        ref_pyr, src_pyr = batch.ref, batch.src
        coarse, fine = ref_pyr.num_stages - 1, 1
        ref_points_c, src_points_c = ref_pyr.points[coarse], src_pyr.points[coarse]
        ref_points_f, src_points_f = ref_pyr.points[fine], src_pyr.points[fine]
        ref_mask_c, src_mask_c = ref_pyr.mask(coarse), src_pyr.mask(coarse)
        ref_mask_f, src_mask_f = ref_pyr.mask(fine), src_pyr.mask(fine)
        out: Dict[str, Any] = {
            "ref_points_c": ref_points_c, "src_points_c": src_points_c,
            "ref_points_f": ref_points_f, "src_points_f": src_points_f,
            "ref_mask_c": ref_mask_c, "src_mask_c": src_mask_c,
            "ref_mask_f": ref_mask_f, "src_mask_f": src_mask_f,
        }

        # backbone on the stacked pair (GroupNorm statistics shared)
        graph = stack_pair_graph(ref_pyr, src_pyr)
        cap_c, cap_f = ref_points_c.shape[0], ref_points_f.shape[0]
        feats_list = self.encoder(torch.cat([batch.ref_feats, batch.src_feats]), graph)
        # float32 into every family: GeoTransformer and APE compute in float32,
        # ThDRoFormer casts to the compute dtype itself (bf16 -> f32 is exact)
        feats_c = feats_list[-1].float().reshape(2, cap_c, -1)
        ref_feats_c, src_feats_c = self.transformer(
            ref_points_c, src_points_c, feats_c[0], feats_c[1],
            ref_valid=ref_mask_c, src_valid=src_mask_c)
        ref_n2p = self.proj_n2p_score(ref_feats_c)
        src_n2p = self.proj_n2p_score(src_feats_c)
        out["ref_n2p_scores_c"] = torch.sigmoid(ref_n2p[:, 0])
        out["src_n2p_scores_c"] = torch.sigmoid(src_n2p[:, 0])
        mark("encoder+T1")

        coarse_cond = torch.cat([torch.cat([ref_feats_c, ref_n2p], dim=1),
                                 torch.cat([src_feats_c, src_n2p], dim=1)])
        dec = self.decoder(list(feats_list[:-1]) + [coarse_cond], graph)
        dec_f = dec[0].reshape(2, cap_f, -1)
        ref_feats_f, src_feats_f = dec_f[0][:, :-1], dec_f[1][:, :-1]
        out["ref_feats_f"], out["src_feats_f"] = ref_feats_f, src_feats_f
        out["ref_p2p_scores_c"] = torch.sigmoid(dec_f[0][:, -1])
        out["src_p2p_scores_c"] = torch.sigmoid(dec_f[1][:, -1])
        mark("decoder")

        points_c_pair = torch.stack([ref_points_c, src_points_c])
        mask_pair = torch.stack([ref_mask_c, src_mask_c])
        if cfg.vote.model_use_vote:
            if with_gt:
                out["vote_mask_mat"] = mutual_nearest_node_masks(
                    ref_points_c, src_points_c, batch.transform,
                    cfg.model.ground_truth_corres_radius, ref_mask_c, src_mask_c)
            shifted_pair, voted_feats = self.vote(points_c_pair,
                                                  torch.stack([ref_feats_c, src_feats_c]))
            shifted_pair = torch.where(mask_pair[..., None], shifted_pair, points_c_pair)
            out["shifted_ref_points_c"] = shifted_pair[0]
            out["shifted_src_points_c"] = shifted_pair[1]
            n2n = self.proj_n2n_score(voted_feats)[..., 0]
            out["ref_n2n_scores_c"] = torch.sigmoid(n2n[0])
            out["src_n2n_scores_c"] = torch.sigmoid(n2n[1])
        if cfg.vote.model_use_vote and cfg.vote.inference_use_vote:
            # node selection and partition decide indices only: no gradient
            nodes_pair = shifted_pair.detach()
            keep_pair, rounds = greedy_nms(nodes_pair, mask_pair, cfg.vote.nms_radius,
                                           neighbor_limit=cfg.vote.nms_neighbor_limit)
            out["nms_rounds"] = rounds
            node_valid = mask_pair & keep_pair
            ref_feats_c, src_feats_c = self.transformer2(
                shifted_pair[0], shifted_pair[1], voted_feats[0], voted_feats[1],
                ref_valid=node_valid[0], src_valid=node_valid[1])
            out["nodes_ref"], out["nodes_src"] = shifted_pair[0], shifted_pair[1]
        else:
            # no vote layer, or one whose outputs only feed the losses (the
            # MulRan setting): matching takes the unshifted nodes and the
            # first transformer's features
            nodes_pair, node_valid = points_c_pair, mask_pair
            out["nms_rounds"] = torch.zeros((), dtype=torch.int32, device=mask_pair.device)
            out["nodes_ref"], out["nodes_src"] = ref_points_c, src_points_c
        out["nodes_ref_valid"], out["nodes_src_valid"] = node_valid[0], node_valid[1]
        ref_feats_c = ref_feats_c / (torch.linalg.norm(ref_feats_c, dim=1, keepdim=True) + 1e-12)
        src_feats_c = src_feats_c / (torch.linalg.norm(src_feats_c, dim=1, keepdim=True) + 1e-12)
        out["ref_feats_c"], out["src_feats_c"] = ref_feats_c, src_feats_c
        mark("vote/NMS/T2")

        k = cfg.model.num_points_in_patch
        _, ref_node_masks, ref_knn_idx, ref_knn_masks = point_to_node_partition(
            ref_points_f, ref_mask_f, nodes_pair[0], node_valid[0], k)
        _, src_node_masks, src_knn_idx, src_knn_masks = point_to_node_partition(
            src_points_f, src_mask_f, nodes_pair[1], node_valid[1], k)
        out["ref_node_masks"], out["src_node_masks"] = ref_node_masks, src_node_masks
        if with_gt:
            out["gt_node_corr_overlaps"] = node_correspondence_overlaps(
                nodes_pair[0], nodes_pair[1], take_padded(ref_points_f, ref_knn_idx),
                take_padded(src_points_f, src_knn_idx), batch.transform,
                cfg.model.ground_truth_matching_radius, ref_node_masks, src_node_masks,
                ref_knn_masks, src_knn_masks)
        ref_corr, src_corr, corr_scores, corr_valid = superpoint_matching(
            ref_feats_c.detach(), src_feats_c.detach(), ref_node_masks, src_node_masks,
            cfg.coarse_matching.num_correspondences, cfg.coarse_matching.dual_normalization)
        out["ref_node_corr_indices"], out["src_node_corr_indices"] = ref_corr, src_corr
        out["node_corr_valid"] = corr_valid
        out["node_corr_scores"] = corr_scores
        if training:
            ref_corr, src_corr, corr_scores, corr_valid = superpoint_target_sample(
                out["gt_node_corr_overlaps"], cfg.coarse_matching.num_targets,
                cfg.coarse_matching.overlap_threshold, generator)
        elif node_corr is not None:
            ref_corr, src_corr, corr_scores, corr_valid = node_corr
        mark("matching")

        rc, sc = ref_corr.long(), src_corr.long()
        p_ref_idx, p_src_idx = ref_knn_idx[rc], src_knn_idx[sc]
        p_ref_masks = ref_knn_masks[rc] & corr_valid[:, None]
        p_src_masks = src_knn_masks[sc] & corr_valid[:, None]
        p_ref_points = take_padded(ref_points_f, p_ref_idx)
        p_src_points = take_padded(src_points_f, p_src_idx)
        p_ref_feats = take_padded(ref_feats_f, p_ref_idx)
        p_src_feats = take_padded(src_feats_f, p_src_idx)
        out["ref_node_corr_knn_points"], out["src_node_corr_knn_points"] = p_ref_points, p_src_points
        out["ref_node_corr_knn_masks"], out["src_node_corr_knn_masks"] = p_ref_masks, p_src_masks
        sim = (p_ref_feats @ p_src_feats.transpose(1, 2)) / math.sqrt(ref_feats_f.shape[1])
        matching_scores = self.optimal_transport(sim, p_ref_masks, p_src_masks,
                                                 use_kernel=not training)
        out["matching_scores"] = matching_scores
        mark("OT")

        if not training:
            corr, transform = local_to_global_registration(
                p_ref_points, p_src_points, p_ref_masks, p_src_masks, matching_scores.detach(),
                corr_valid, cfg.fine_matching, node_corr_scores=corr_scores)
            out["ref_corr_points"], out["src_corr_points"] = corr.ref_points, corr.src_points
            out["corr_scores"] = corr.scores
            out["estimated_transform"] = transform
            mark("LGR")
        return out
