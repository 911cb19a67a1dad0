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

``cfg.compute_dtype`` (``"float32"`` or ``"bfloat16"``) is the dtype of the
encoder, decoder and both ThDRoFormers (``nn/precision.py``). Their outputs
come back as float32, so the score heads, the vote layer, GeoTransformer and
APE, matching, Sinkhorn and the pose stay float32, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from rdmnet_tpu_torch import trace
from rdmnet_tpu_torch.config import Config, PyramidConfig
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.graph.pyramid import PairBatch, build_pair_batch, stack_pair_graph
from rdmnet_tpu_torch.nn.backbone import Decoder, Encoder
from rdmnet_tpu_torch.nn.geotransformer import GeometricTransformer
from rdmnet_tpu_torch.nn.kpconv import KPConv
from rdmnet_tpu_torch.nn.matching import superpoint_matching, superpoint_target_sample
from rdmnet_tpu_torch.nn.precision import compute_dtype
from rdmnet_tpu_torch.nn.sinkhorn import LearnableLogOptimalTransport
from rdmnet_tpu_torch.nn.thdroformer import APETransformer, ThDRoFormer
from rdmnet_tpu_torch.nn.transformers import LearnablePositionalEmbedding
from rdmnet_tpu_torch.nn.vote import VoteLayer
from rdmnet_tpu_torch.ops.correspondences import (
    mutual_nearest_node_masks,
    node_correspondence_overlaps,
)
from rdmnet_tpu_torch.ops.geometry import take_padded
from rdmnet_tpu_torch.ops.lgr import local_to_global_registration
from rdmnet_tpu_torch.ops.nms import greedy_nms
from rdmnet_tpu_torch.ops.partition import point_to_node_partition
from rdmnet_tpu_torch.program import CAPTURE_WARMUP

# the served pipeline's stages, each closed by the stage mark of its name (``trace.mark``)
STAGES = ("build", "encoder_t1", "decoder", "vote_t2", "matching", "ot", "lgr")


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
    ref_valid, src_valid)``; only ThDRoFormer takes ``cfg.compute_dtype``."""
    kind = cfg.model.coarse_module
    td = cfg.thdroformer
    in_dim = td.input_dim if stage == 1 else td.input_dim2
    layers = td.num_layers if stage == 1 else td.num_layers2
    if kind == "thdroformer":
        return ThDRoFormer(in_dim, td.output_dim, td.hidden_dim, td.num_heads, layers,
                           k=None if stage == 1 else td.k2,
                           dtype=compute_dtype(cfg.compute_dtype))
    if kind == "geotransformer":
        g = cfg.geotransformer
        return GeometricTransformer(in_dim, g.output_dim, g.hidden_dim, g.num_heads, g.blocks,
                                    g.sigma_d, g.sigma_a, g.angle_k, g.reduction_a)
    if kind == "ape":
        return APETransformer(in_dim, td.output_dim, td.hidden_dim, td.num_heads, layers)
    raise ValueError(f"unknown coarse_module {kind!r}")


class RDMNet(nn.Module):
    def __init__(self, cfg: Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kind = cfg.model.coarse_module
        out_dim = cfg.geotransformer.output_dim if kind == "geotransformer" \
            else cfg.thdroformer.output_dim
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
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(cfg.seed))
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.proj_n2p_score.weight.device

    def forward(self, batch: PairBatch, training: bool = False, with_gt: bool = False,
                generator: Optional[torch.Generator] = None,
                node_corr: Optional[Tuple[torch.Tensor, ...]] = None) -> Dict[str, Any]:
        """One pair. Autograd stays on unless the caller turns it off
        (``pipeline`` runs inference under ``no_grad``).

        ``training`` needs ``with_gt`` and a ``generator`` on the batch's
        device for the target sample; it runs Sinkhorn's plain version under
        autograd (the CUDA kernel has no backward), inference the kernel.
        Each stage of ``STAGES[1:]`` ends with its ``trace.mark``. ``node_corr`` (ref indices, src
        indices, scores, valid), when given, replaces the matched node pairs
        that the patches, optimal transport and LGR take (the outputs'
        ``node_corr_*`` stay the model's own): one device's run replayed on
        another's node pairs."""
        if training and (not with_gt or generator is None):
            raise ValueError("training=True needs with_gt=True and a generator")
        cfg = self.cfg
        ref_pyr, src_pyr = batch.ref, batch.src
        coarse, fine = ref_pyr.num_stages - 1, 1
        ref_points_c, src_points_c = ref_pyr.points[coarse], src_pyr.points[coarse]
        ref_points_f, src_points_f = ref_pyr.points[fine], src_pyr.points[fine]
        ref_mask_c, src_mask_c = ref_pyr.mask(coarse), src_pyr.mask(coarse)
        ref_mask_f, src_mask_f = ref_pyr.mask(fine), src_pyr.mask(fine)
        dev = ref_points_c.device
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
        trace.mark("encoder_t1", dev)

        coarse_cond = torch.cat([torch.cat([ref_feats_c, ref_n2p], dim=1),
                                 torch.cat([src_feats_c, src_n2p], dim=1)])
        dec = self.decoder(list(feats_list[:-1]) + [coarse_cond], graph)
        dec_f = dec[0].reshape(2, cap_f, -1)
        ref_feats_f, src_feats_f = dec_f[0][:, :-1], dec_f[1][:, :-1]
        out["ref_feats_f"], out["src_feats_f"] = ref_feats_f, src_feats_f
        out["ref_p2p_scores_c"] = torch.sigmoid(dec_f[0][:, -1])
        out["src_p2p_scores_c"] = torch.sigmoid(dec_f[1][:, -1])
        trace.mark("decoder", dev)

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
        trace.mark("vote_t2", dev)

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
        trace.mark("matching", dev)

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
        trace.mark("ot", dev)

        if not training:
            corr, transform = local_to_global_registration(
                p_ref_points, p_src_points, p_ref_masks, p_src_masks, matching_scores.detach(),
                corr_valid, cfg.fine_matching, node_corr_scores=corr_scores)
            out["ref_corr_points"], out["src_corr_points"] = corr.ref_points, corr.src_points
            out["corr_scores"] = corr.scores
            out["estimated_transform"] = transform
            trace.mark("lgr", dev)
        return out


def pipeline(model: RDMNet, rp, rc, sp, sc, device=None) -> Dict[str, Any]:
    """Graph build plus inference on one padded pair: the program
    ``bench.py`` times (``build_pair_batch`` then the model).

    rp/sp (cap_0, 3) padded clouds, rc/sc their valid counts. Runs on
    ``device`` (default CUDA; raises without a card). Returns the model's
    outputs plus ``dropped`` ((2, num_stages) int32 overflow telemetry).
    Marks ``begin`` at its entry and ``build`` after the graph build; the
    model marks its own stages (``trace.mark``).
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, pipeline asked for {dev}")
    with torch.no_grad():
        trace.mark("begin", dev)
        rp = torch.as_tensor(rp, dtype=torch.float32, device=dev)
        sp = torch.as_tensor(sp, dtype=torch.float32, device=dev)
        rc = torch.as_tensor(rc, dtype=torch.int32, device=dev)
        sc = torch.as_tensor(sc, dtype=torch.int32, device=dev)
        batch = build_pair_batch(rp, rc, sp, sc, torch.eye(4, device=dev), model.cfg.pyramid)
        trace.mark("build", dev)
        out = model(batch)
    out["dropped"] = torch.stack([batch.ref.dropped, batch.src.dropped])
    out["batch"] = batch
    return out


def capture_pipeline(model: RDMNet, device=None, pool=None):
    """``pipeline`` at ``model``'s bucket captured once as a CUDA graph: the
    card's counterpart of the JAX export's compiled program per capacity bucket
    (``rdmnet_tpu/serving.py``: build, forward and LGR in one static-shape
    program, replayed with the weights already on the device).

    Returns ``run(rp, rc, sp, sc)``: rp/sp (n <= cap_0, 3) clouds (numpy or
    CPU tensors; rows past n are written as ``PAD_COORD``, so no row of an
    earlier request survives), rc/sc their valid counts. ``run`` stages them
    in pinned host buffers, copies them into the program's static inputs on
    the card, replays the graph and returns ``pipeline``'s outputs: the same
    tensors on every call, overwritten by the next replay and valid once the
    current stream reaches them. No Python model code runs per call. The
    caller serialises calls and consumes each call's outputs before the
    next one (``serving.load_exported`` holds a lock); graphs sharing a
    ``pool`` (``torch.cuda.graph_pool_handle()``) are replayed one at a time.
    ``run.stage(rp, rc, sp, sc)`` and ``run.launch()`` are its two halves
    (the host's staging; the copies and the replay), for a caller that
    traces them apart.

    Before the capture ``pipeline`` runs ``CAPTURE_WARMUP`` times on a side stream
    (PyTorch's capture recipe: kernels built, cuBLAS handles made) under
    ``torch.cuda.set_sync_debug_mode("error")``, so an op that waits for the
    host raises there with its traceback; a capture that fails raises.
    ``run.launches`` holds each kernel's launches in the program (counted
    once, at the capture: a replay does not tick the wrappers' counters),
    ``run.path_launches`` the kNN's and Sinkhorn's per path, ``run.capture_s``
    the seconds the warm-up and capture took, ``run.memory_bytes`` the device
    memory the program keeps allocated (its static inputs and outputs; the
    graph's other buffers stay reserved in its pool). Raises on a CPU device:
    ``pipeline`` runs eagerly there."""
    import time

    import numpy as np

    from rdmnet_tpu_torch.graph.pyramid import PAD_COORD
    from rdmnet_tpu_torch.ops.kernels import all_launch_counts, path_launch_counts

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"capture_pipeline: a CUDA graph needs a CUDA device, got {dev}; "
                         "pipeline runs eagerly there")
    if model.device.type != "cuda":
        raise ValueError(f"capture_pipeline: model lives on {model.device}")
    dev = model.device
    cap = model.cfg.pyramid.caps[0]
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        before = torch.cuda.memory_allocated(dev)
        host = [torch.full((cap, 3), PAD_COORD, dtype=torch.float32, pin_memory=True),
                torch.zeros((), dtype=torch.int32, pin_memory=True),
                torch.full((cap, 3), PAD_COORD, dtype=torch.float32, pin_memory=True),
                torch.zeros((), dtype=torch.int32, pin_memory=True)]
        static = [h.to(dev) for h in host]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                for _ in range(CAPTURE_WARMUP):
                    pipeline(model, *static, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        trace.ready(dev)
        graph = torch.cuda.CUDAGraph()
        counts, paths = all_launch_counts(), path_launch_counts()
        try:
            with torch.cuda.graph(graph, pool=pool):
                out = pipeline(model, *static, device=dev)
        except RuntimeError as e:
            raise RuntimeError(f"capture_pipeline: capturing the pipeline at bucket {cap} "
                               f"failed: {e}") from e
        torch.cuda.synchronize(dev)
        memory = torch.cuda.memory_allocated(dev) - before
        copied = torch.cuda.Event()  # the last call's copies out of the staging buffers
    capture_s = time.perf_counter() - t0

    def stage(buf, points):
        pts = torch.as_tensor(np.asarray(points, np.float32)[:, :3])
        n = pts.shape[0]
        if n > cap:
            raise ValueError(f"capture_pipeline: {n} rows for a program of capacity {cap}")
        buf[:n].copy_(pts)
        buf[n:].fill_(PAD_COORD)

    def stage_all(rp, rc, sp, sc):
        copied.synchronize()  # a call not yet fetched may still read the staging buffers
        stage(host[0], rp)
        host[1].fill_(int(rc))
        stage(host[2], sp)
        host[3].fill_(int(sc))

    def launch():
        with torch.cuda.device(dev):
            for h, s in zip(host, static):
                s.copy_(h, non_blocking=True)
            copied.record()
            graph.replay()
        return out

    def run(rp, rc, sp, sc):
        stage_all(rp, rc, sp, sc)
        return launch()

    run.stage, run.launch = stage_all, launch
    run.outputs = out
    run.capture_s = capture_s
    run.memory_bytes = memory
    run.launches = {k: v - counts[k] for k, v in all_launch_counts().items()}
    run.path_launches = {k: {p: n - paths[k][p] for p, n in v.items()}
                         for k, v in path_launch_counts().items()}
    return run


def with_pyramid(model: RDMNet, pyramid: PyramidConfig) -> RDMNet:
    """``model`` at another capacity bucket: a shallow copy that shares every
    parameter and buffer tensor and carries ``pyramid`` in its config, which
    only ``pipeline``'s graph build reads (the forward reads no pyramid
    field)."""
    view = copy.copy(model)
    view.cfg = dataclasses.replace(model.cfg, pyramid=pyramid)
    return view
