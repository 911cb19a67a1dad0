"""Quick-demo inference of the port over the bundled scan pairs (twin of
``rdmnet_tpu/cli/infer.py``; reference experiments/infer.py:19-129):
predicts correspondences and the relative pose, writes KITTI-format pose
lines and one npz per pair, with a RANSAC re-solve of the predicted
correspondences beside the LGR pose.

Usage:
    rdmnet-torch-infer --asset_dir DIR [--snapshot_dir DIR [--test_epoch N]]
                       [--torch_checkpoint F | --parity_cfg] [--coarse_module NAME]
                       [--output_dir DIR] [--device cpu] [--ransac_iterations N]

``--asset_dir`` holds ``000000.npy``, ``000004.npy`` and ``000007.npy``.
Without ``--snapshot_dir`` or ``--torch_checkpoint`` the weights are drawn
from the config's seed. On the card each pair replays the forward captured
once as a CUDA graph (``models.capture_pipeline``), and the RANSAC re-solve
replays its program (``ops.ransac``); on the CPU both run eagerly.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def format_pose_line(ref_frame: int, src_frame: int, est: np.ndarray) -> str:
    """'ref_frame src_frame' + 12 transform floats, the reference's
    14-field pose-file line (reference infer.py:73)."""
    return f"{ref_frame} {src_frame} " + " ".join(
        f"{v:.6f}" for v in np.asarray(est)[:3].reshape(-1)
    )


def _make_forward(cfg, model, device):
    """``(rp, rc, sp, sc) -> outputs`` without ground truth: on the card a
    replay of ``models.capture_pipeline`` at ``cfg``'s bucket (its outputs
    are overwritten by the next call), elsewhere ``common.make_forward``,
    the eager oracle, with the identity transform."""
    from rdmnet_tpu_torch.cli.common import make_forward
    from rdmnet_tpu_torch.device import resolve_device
    from rdmnet_tpu_torch.models import capture_pipeline

    dev = resolve_device(device)
    if dev.type == "cuda":
        return capture_pipeline(model, dev)
    forward = make_forward(cfg, model, with_gt=False, device=dev)
    return lambda rp, rc, sp, sc: forward(rp, rc, sp, sc, np.eye(4, dtype=np.float32))


def main(argv=None):
    from rdmnet_tpu_torch.cli.common import (add_model_overrides, add_pyramid_overrides,
                                             build_model_and_params, make_cli_cfg, pad_pair_np,
                                             trim_outputs)
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset

    parser = argparse.ArgumentParser()
    add_pyramid_overrides(parser)
    add_model_overrides(parser)
    parser.add_argument("--snapshot_dir", default=None)
    parser.add_argument("--test_epoch", type=int, default=None)
    parser.add_argument("--asset_dir", required=True)
    parser.add_argument("--output_dir", default="output/infer")
    parser.add_argument("--ransac_iterations", type=int, default=50000)
    args = parser.parse_args(argv)

    cfg = make_cli_cfg(args)
    os.makedirs(args.output_dir, exist_ok=True)

    dataset = RegistrationPairDataset(
        "kitti", root=args.asset_dir, subset="infer", demo_asset_dir=args.asset_dir
    )
    model = build_model_and_params(cfg, args.snapshot_dir, args.test_epoch, device=args.device,
                                   torch_checkpoint=args.torch_checkpoint)
    forward = _make_forward(cfg, model, args.device)

    pose_lines = []
    for i in range(len(dataset)):
        item = dataset[i]
        rp, rc, sp, sc = pad_pair_np(cfg, item["ref_points"], item["src_points"])
        out = forward(rp, rc, sp, sc)
        dumped = trim_outputs(out, np.eye(4, dtype=np.float32))
        est = dumped["estimated_transform"]

        # RANSAC re-solve of the predicted correspondences, stored beside
        # the LGR pose (reference infer.py:75-82 does this with o3d RANSAC);
        # --ransac_iterations 0 skips it
        if args.ransac_iterations > 0:
            from rdmnet_tpu_torch.ops.ransac import ransac_registration_host

            cfg_r = cfg.ransac
            dumped["ransac_transform"] = ransac_registration_host(
                dumped["src_corr_points"], dumped["ref_corr_points"], dumped["corr_scores"],
                num_iterations=args.ransac_iterations, num_samples=cfg_r.num_points,
                threshold=cfg_r.distance_threshold, device=args.device,
            )

        name = f"{item['seq_id']}_{item['src_frame']}_{item['ref_frame']}"
        np.savez_compressed(osp.join(args.output_dir, name + ".npz"), **dumped)
        pose_lines.append(format_pose_line(item["ref_frame"], item["src_frame"], est))
        print(
            f"pair {item['src_frame']}->{item['ref_frame']}: "
            f"{len(dumped['corr_scores'])} correspondences\n{est}"
        )

    with open(osp.join(args.output_dir, f"{dataset.metadata[0]['seq_id']:02d}_pose"), "w") as f:
        f.write("\n".join(pose_lines) + "\n")
    print(f"wrote {args.output_dir}")


if __name__ == "__main__":
    main()
