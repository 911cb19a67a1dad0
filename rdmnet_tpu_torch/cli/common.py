"""Shared CLI helpers of the port (twin of ``rdmnet_tpu/cli/common.py``):
config selection and overrides, the seeded model, host padding, the
forward, and padded -> dynamic output trimming.

``--device`` (``cuda`` or ``cpu``) takes the place of the JAX CLIs'
``--platform``. Where the JAX CLIs jit, the port captures CUDA graphs on the
card, at run time, so there is no compile cache to set up.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from rdmnet_tpu_torch.config import Config


def add_pyramid_overrides(parser) -> None:
    """Per-dataset static-capacity knobs, the device and the config preset."""
    parser.add_argument(
        "--neighbor_limits", default=None,
        help="per-level neighbor K, comma ints, e.g. 65,63,69,71,81",
    )
    parser.add_argument(
        "--band_caps", default=None,
        help="per-level banded-search caps, comma ints with 'none' to disable "
             "banding for a level, e.g. 7168,3584,2304,none,none",
    )
    parser.add_argument(
        "--caps", default=None,
        help="per-level pyramid point capacities, comma ints (e.g. "
             "30000,12288,5120,2048,1024); applied before any bucket scaling",
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the port runs: cuda (default; fails without a card) or "
             "cpu (the kernels' plain versions)",
    )
    parser.add_argument(
        "--cfg_preset", default=None, choices=["tiny"],
        help="config preset override: 'tiny' = config.make_tiny_cfg() "
             "(miniature capacities; tests and plumbing runs only)",
    )


def apply_pyramid_overrides(cfg: Config, args) -> Config:
    """Apply --caps/--neighbor_limits/--band_caps onto cfg.pyramid (before
    any bucket scaling, which multiplies caps and bands)."""
    pyr = cfg.pyramid
    if getattr(args, "caps", None):
        caps = tuple(int(v) for v in args.caps.split(","))
        if len(caps) != len(pyr.caps):
            raise ValueError(f"--caps needs {len(pyr.caps)} per-level values, got {len(caps)}")
        pyr = dataclasses.replace(pyr, caps=caps)
    if getattr(args, "neighbor_limits", None):
        limits = tuple(int(v) for v in args.neighbor_limits.split(","))
        pyr = dataclasses.replace(pyr, neighbor_limits=limits)
    if getattr(args, "band_caps", None):
        bands = tuple(
            None if v.strip().lower() in ("none", "-", "") else int(v)
            for v in args.band_caps.split(",")
        )
        # measured values survive bucket scaling verbatim
        pyr = dataclasses.replace(pyr, band_caps=bands, band_caps_fixed=True)
    return dataclasses.replace(cfg, pyramid=pyr) if pyr is not cfg.pyramid else cfg


COARSE_MODULES = ("thdroformer", "geotransformer", "ape")


def add_coarse_module_flag(parser) -> None:
    parser.add_argument("--coarse_module", default=None, choices=COARSE_MODULES,
                        help="coarse transformer family (default thdroformer)")


def add_model_overrides(parser, torch_checkpoint: bool = True) -> None:
    """``--coarse_module``, ``--parity_cfg``, ``--no_parity_cfg`` and (unless
    ``torch_checkpoint=False``) ``--torch_checkpoint``."""
    if torch_checkpoint:
        parser.add_argument("--torch_checkpoint", default=None,
                            help="upstream RDMNet .pth.tar to load (converted at startup); "
                                 "implies --parity_cfg unless --no_parity_cfg")
        parser.add_argument("--no_parity_cfg", action="store_true",
                            help="keep the default config with --torch_checkpoint")
    parser.add_argument("--parity_cfg", action="store_true",
                        help="the config of the upstream checkpoints (config.make_parity_cfg): "
                             "neighbour limits 65,63,69,71,81, a kernel disposition per layer, "
                             "NMS adjacency cut to 81; needed for weights converted by "
                             "rdmnet-torch-convert")
    add_coarse_module_flag(parser)


def uses_parity_cfg(args) -> bool:
    """``--parity_cfg``, or ``--torch_checkpoint`` without ``--no_parity_cfg``."""
    return bool(getattr(args, "parity_cfg", False) or (
        getattr(args, "torch_checkpoint", None) and not getattr(args, "no_parity_cfg", False)))


def make_cli_cfg(args) -> Config:
    """The config of a CLI run: ``make_tiny_cfg()`` under ``--cfg_preset
    tiny``, else ``make_parity_cfg()`` when ``uses_parity_cfg(args)``, else
    ``make_cfg()``; then ``--coarse_module`` and the pyramid overrides."""
    from rdmnet_tpu_torch.config import make_cfg, make_parity_cfg, make_tiny_cfg

    if getattr(args, "cfg_preset", None) == "tiny":
        cfg = make_tiny_cfg()
    elif uses_parity_cfg(args):
        cfg = make_parity_cfg()
    else:
        cfg = make_cfg()
    coarse = getattr(args, "coarse_module", None)
    if coarse is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, coarse_module=coarse))
    return apply_pyramid_overrides(cfg, args)


def build_model_and_params(cfg: Config, snapshot_dir: Optional[str] = None,
                           epoch: Optional[int] = None, device=None,
                           torch_checkpoint: Optional[str] = None):
    """The model on ``device`` (CUDA unless told otherwise) with the weights
    of an upstream ``torch_checkpoint`` (``.pth.tar``, through
    ``utils/torch_convert``; use with ``make_parity_cfg()``), or of
    ``snapshot_dir``'s snapshot ``epoch`` (the latest if None), whatever
    optimizer the snapshot was saved with; with neither, weights drawn from
    ``cfg.seed``. A missing ``snapshot_dir`` raises: a mistyped path must
    not evaluate random weights. The port's model holds its parameters, so
    it is returned alone."""
    from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager
    from rdmnet_tpu_torch.models import RDMNet

    if snapshot_dir and not os.path.isdir(snapshot_dir):
        raise FileNotFoundError(f"snapshot_dir not found: {snapshot_dir}")
    model = RDMNet(cfg, device=device, generator=torch.Generator().manual_seed(cfg.seed))
    if torch_checkpoint:
        from rdmnet_tpu_torch.utils.torch_convert import convert_state_dict, load_torch_checkpoint

        model.load_state_dict(convert_state_dict(load_torch_checkpoint(torch_checkpoint)),
                              strict=True)
    elif snapshot_dir:
        model.load_state_dict(CheckpointManager(snapshot_dir).restore_params(epoch), strict=True)
    return model


def pad_pair_np(cfg: Config, ref_points: np.ndarray, src_points: np.ndarray):
    """Host-side padding to ``cfg.pyramid.caps[0]``; level-0 truncation is
    ``len(points) - count``."""
    from rdmnet_tpu_torch.data.loader import pad_points_np

    cap = cfg.pyramid.caps[0]
    rp, n_ref = pad_points_np(ref_points, cap)
    sp, n_src = pad_points_np(src_points, cap)
    return rp, n_ref, sp, n_src


def make_forward(cfg: Config, model, with_gt: bool, device=None):
    """Padded arrays in -> the model's outputs: the graph build at
    ``cfg.pyramid`` and the forward on ``device`` (CUDA unless told
    otherwise), without autograd, run eagerly. On the card ``infer`` and
    ``test`` replay captured programs of this forward
    (``models.capture_pipeline``, ``cli/test.py``'s program per bucket); this
    eager function is what they are held to."""
    from rdmnet_tpu_torch.device import resolve_device
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch

    dev = resolve_device(device)

    def forward(rp, rc, sp, sc, transform):
        with torch.no_grad():
            f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
            i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
            batch = build_pair_batch(f32(rp), i32(rc), f32(sp), i32(sc), f32(transform),
                                     cfg.pyramid)
            return model(batch, with_gt=with_gt)

    return forward


# the model-output keys trim_outputs consumes: one host copy of these only
_TRIM_KEYS = (
    "ref_points_f", "src_points_f", "ref_mask_f", "src_mask_f",
    "nodes_ref", "nodes_src", "nodes_ref_valid", "nodes_src_valid",
    "ref_feats_c", "src_feats_c",
    "node_corr_valid", "ref_node_corr_indices", "src_node_corr_indices",
    "gt_node_corr_overlaps", "corr_scores", "ref_corr_points",
    "src_corr_points", "estimated_transform",
)
_TRIM_VIS_KEYS = (
    "ref_mask_c", "src_mask_c", "ref_points_c", "src_points_c",
    "shifted_ref_points_c", "shifted_src_points_c",
)


def trim_outputs(out: Dict, transform: np.ndarray,
                 vis: bool = False) -> Dict[str, np.ndarray]:
    """Convert padded static outputs to the reference's dynamic npz schema
    (reference experiments/test.py:70-98): masked rows dropped, node indices
    remapped to the trimmed node arrays, GT overlaps densified to (C, 2)
    index + overlap lists. ``vis=True`` adds the ``vis_*`` extras (original
    and shifted coarse nodes, NMS survivor masks)."""
    keys = _TRIM_KEYS + (_TRIM_VIS_KEYS if vis else ())
    o = {k: (out[k].cpu().numpy() if isinstance(out[k], torch.Tensor) else np.asarray(out[k]))
         for k in keys if k in out and hasattr(out[k], "shape")}

    ref_nv = o["nodes_ref_valid"]
    src_nv = o["nodes_src_valid"]
    ref_remap = np.cumsum(ref_nv) - 1
    src_remap = np.cumsum(src_nv) - 1

    result = {
        "ref_points": o["ref_points_f"][o["ref_mask_f"]],   # level-1 points
        "src_points": o["src_points_f"][o["src_mask_f"]],
        "ref_points_f": o["ref_points_f"][o["ref_mask_f"]],
        "src_points_f": o["src_points_f"][o["src_mask_f"]],
        "ref_points_c": o["nodes_ref"][ref_nv],
        "src_points_c": o["nodes_src"][src_nv],
        "ref_feats_c": o["ref_feats_c"][ref_nv],
        "src_feats_c": o["src_feats_c"][src_nv],
        "transform": np.asarray(transform),
    }

    cv = o["node_corr_valid"]
    result["ref_node_corr_indices"] = ref_remap[o["ref_node_corr_indices"][cv]]
    result["src_node_corr_indices"] = src_remap[o["src_node_corr_indices"][cv]]

    if "gt_node_corr_overlaps" in o:
        ov = o["gt_node_corr_overlaps"]
        ri, si = np.nonzero(ov > 0)
        result["gt_node_corr_indices"] = np.stack([ref_remap[ri], src_remap[si]], axis=1)
        result["gt_node_corr_overlaps"] = ov[ri, si]

    if "corr_scores" in o:
        sel = o["corr_scores"] > 0
        result["ref_corr_points"] = o["ref_corr_points"][sel]
        result["src_corr_points"] = o["src_corr_points"][sel]
        result["corr_scores"] = o["corr_scores"][sel]
    if "estimated_transform" in o:
        result["estimated_transform"] = o["estimated_transform"]
    if vis:
        # vote/grouping export inputs (reference vis_shifte_node /
        # vis_node_grouping, rdmnet/utils/visualization.py:296-436)
        for side in ("ref", "src"):
            mc = o[f"{side}_mask_c"]
            result[f"vis_{side}_nodes"] = o[f"{side}_points_c"][mc]
            if f"shifted_{side}_points_c" in o:
                result[f"vis_{side}_shifted"] = o[f"shifted_{side}_points_c"][mc]
            result[f"vis_{side}_keep"] = o[f"nodes_{side}_valid"][mc]
    return result
