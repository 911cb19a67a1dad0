"""RDMNet on one pair (twin of ``rdmnet_tpu/models/rdmnet.py``).

Order: stacked-pair KPConv encoder -> coarse transformer #1 -> decoder ->
vote, NMS -> coarse transformer #2 -> point-to-node partition -> superpoint
matching -> patch Sinkhorn -> local-to-global registration. The coarse
transformer family is ``cfg.model.coarse_module`` (ThDRoFormer, with the
sparse ``k2`` schedule on stage 2 only; GeoTransformer; APE). Without the
vote layer (``model_use_vote=False``) there is no vote, NMS or second
transformer: the coarse points are the nodes. ``with_gt`` adds the
ground-truth targets the losses read (vote masks, patch overlaps);
``training`` swaps the matched patches for sampled ground-truth ones, runs
Sinkhorn under autograd and skips registration. Submodules carry the flax
tree's names (``encoder``, ``transformer``, ``proj_n2p_score``, ``decoder``,
``vote``, ``proj_n2n_score``, ``transformer2``, ``optimal_transport``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from rdmnet_tpu_torch.config import Config, PyramidConfig
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.graph.pyramid import PairBatch, build_pair_batch, stack_pair_graph
from rdmnet_tpu_torch.nn.backbone import Decoder, Encoder
from rdmnet_tpu_torch.nn.geotransformer import GeometricTransformer
from rdmnet_tpu_torch.nn.kpconv import KPConv
from rdmnet_tpu_torch.nn.matching import superpoint_matching, superpoint_target_sample
from rdmnet_tpu_torch.nn.sinkhorn import LearnableLogOptimalTransport
from rdmnet_tpu_torch.nn.thdroformer import APETransformer, ThDRoFormer
from rdmnet_tpu_torch.nn.transformers import LearnablePositionalEmbedding
from rdmnet_tpu_torch.nn.vote import VoteLayer
from rdmnet_tpu_torch.ops.correspondences import (
    mutual_nearest_node_masks,
    node_correspondence_overlaps,
)
from rdmnet_tpu_torch.ops.geometry import take_padded
from rdmnet_tpu_torch.ops.kernels.radius_knn import KMAX
from rdmnet_tpu_torch.ops.kernels.sinkhorn import MAX_K1
from rdmnet_tpu_torch.ops.lgr import local_to_global_registration
from rdmnet_tpu_torch.ops.nms import greedy_nms
from rdmnet_tpu_torch.ops.partition import point_to_node_partition

STAGES = ("build", "encoder+T1", "decoder", "vote/NMS/T2", "matching", "OT", "LGR")


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from an explicit generator, flax's init families:
    Linear weight N(0, 1/fan_in) with zero bias, KPConv weights
    U(+-sqrt(1/(K*Cin))) with zero bias, learnable positional embeddings
    N(0, 1), norms at scale 1, bias 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = 1.0 / math.sqrt(mod.in_features)
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
                mod.bias.zero_()
            elif isinstance(mod, KPConv):
                k, cin, _ = mod.weights.shape
                bound = math.sqrt(1.0 / (k * cin))
                mod.weights.copy_((torch.rand(mod.weights.shape, generator=generator) * 2 - 1)
                                  * bound)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LearnablePositionalEmbedding):
                mod.embeddings.copy_(torch.randn(mod.embeddings.shape, generator=generator))


def coarse_transformer(cfg: Config, stage: int) -> nn.Module:
    """The coarse transformer of ``stage`` (1: on the encoder's coarse
    features; 2: on the voted NMS survivors) for ``cfg.model.coarse_module``.
    Every family takes ``(ref_points, src_points, ref_feats, src_feats,
    ref_valid, src_valid)``."""
    kind = cfg.model.coarse_module
    td = cfg.thdroformer
    in_dim = td.input_dim if stage == 1 else td.input_dim2
    layers = td.num_layers if stage == 1 else td.num_layers2
    if kind == "thdroformer":
        return ThDRoFormer(in_dim, td.output_dim, td.hidden_dim, td.num_heads, layers,
                           k=None if stage == 1 else td.k2)
    if kind == "geotransformer":
        g = cfg.geotransformer
        return GeometricTransformer(in_dim, g.output_dim, g.hidden_dim, g.num_heads, g.blocks,
                                    g.sigma_d, g.sigma_a, g.angle_k, g.reduction_a)
    if kind == "ape":
        return APETransformer(in_dim, td.output_dim, td.hidden_dim, td.num_heads, layers)
    raise ValueError(f"unknown coarse_module {kind!r}")


def check_kernel_limits(cfg: Config) -> None:
    """Raise when ``cfg`` asks the CUDA kernels for more than they take: a
    radius search with k > ``KMAX`` or Sinkhorn patches of
    ``num_points_in_patch + 1 > MAX_K1`` rows. The JAX package has no such
    limits; on the card they would otherwise fail in the middle of a
    forward (``RDMNet`` calls it when built on a card)."""
    pyr = cfg.pyramid
    fields = [(f"pyramid.neighbor_limits[{i}]", k) for i, k in enumerate(pyr.neighbor_limits)]
    if pyr.upsampling_limit is not None:
        fields.append(("pyramid.upsampling_limit", pyr.upsampling_limit))
    for name, k in fields:
        if k > KMAX:
            raise ValueError(f"{name} = {k}: the CUDA radius-kNN kernel takes k <= {KMAX}")
    k1 = cfg.model.num_points_in_patch + 1
    if k1 > MAX_K1:
        raise ValueError(f"model.num_points_in_patch = {cfg.model.num_points_in_patch}: the CUDA "
                         f"Sinkhorn kernel takes patches of num_points_in_patch + 1 <= {MAX_K1} "
                         "rows")


class RDMNet(nn.Module):
    def __init__(self, cfg: Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            check_kernel_limits(cfg)
        self.cfg = cfg
        kind = cfg.model.coarse_module
        out_dim = cfg.geotransformer.output_dim if kind == "geotransformer" \
            else cfg.thdroformer.output_dim
        self.encoder = Encoder(cfg.backbone)
        self.transformer = coarse_transformer(cfg, 1)
        self.proj_n2p_score = nn.Linear(out_dim, 1)
        self.decoder = Decoder(cfg.backbone)
        if cfg.vote.model_use_vote:
            self.vote = VoteLayer(cfg.vote, out_dim)
            self.proj_n2n_score = nn.Linear(out_dim, 1)
            self.transformer2 = coarse_transformer(cfg, 2)
        self.optimal_transport = LearnableLogOptimalTransport(cfg.model.num_sinkhorn_iterations)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(cfg.seed))
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.proj_n2p_score.weight.device

    def forward(self, batch: PairBatch, training: bool = False, with_gt: bool = False,
                generator: Optional[torch.Generator] = None,
                stage_hook: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
        """One pair. Autograd stays on unless the caller turns it off
        (``pipeline`` runs inference under ``no_grad``).

        ``training`` needs ``with_gt`` and a ``generator`` on the batch's
        device for the target sample; it runs Sinkhorn's plain version under
        autograd (the CUDA kernel has no backward), inference the kernel.
        ``stage_hook(name)``, when given, is called after each stage of
        ``STAGES[1:]`` (timing breakdowns)."""
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
        feats_c = feats_list[-1].reshape(2, cap_c, -1)
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
            out["nms_rounds"] = 0
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


def pipeline(model: RDMNet, rp, rc, sp, sc, device=None,
             stage_hook: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Graph build plus inference on one padded pair: the program
    ``bench.py`` times (``build_pair_batch`` then the model).

    rp/sp (cap_0, 3) padded clouds, rc/sc their valid counts. Runs on
    ``device`` (default CUDA; raises without a card). Returns the model's
    outputs plus ``dropped`` ((2, num_stages) int32 overflow telemetry).
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, pipeline asked for {dev}")
    with torch.no_grad():
        rp = torch.as_tensor(rp, dtype=torch.float32, device=dev)
        sp = torch.as_tensor(sp, dtype=torch.float32, device=dev)
        rc = torch.as_tensor(rc, dtype=torch.int32, device=dev)
        sc = torch.as_tensor(sc, dtype=torch.int32, device=dev)
        batch = build_pair_batch(rp, rc, sp, sc, torch.eye(4, device=dev), model.cfg.pyramid)
        if stage_hook is not None:
            stage_hook("build")
        out = model(batch, stage_hook=stage_hook)
    out["dropped"] = torch.stack([batch.ref.dropped, batch.src.dropped])
    out["batch"] = batch
    return out


def with_pyramid(model: RDMNet, pyramid: PyramidConfig) -> RDMNet:
    """``model`` at another capacity bucket: a shallow copy that shares every
    parameter and buffer tensor and carries ``pyramid`` in its config, which
    only ``pipeline``'s graph build reads (the forward reads no pyramid
    field)."""
    view = copy.copy(model)
    view.cfg = dataclasses.replace(model.cfg, pyramid=pyramid)
    return view
