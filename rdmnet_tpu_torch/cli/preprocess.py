"""Data preparation CLI (twin of ``rdmnet_tpu/cli/preprocess.py``).

    python -m rdmnet_tpu_torch.cli.preprocess downsample --root /data/KITTI \\
        [--seqs 0 1 2 ...] [--voxel 0.3]
    python -m rdmnet_tpu_torch.cli.preprocess pairs --root /data/KITTI \\
        [--seqs 0 1 2 ...] [--thres 10] [--device cpu]
    python -m rdmnet_tpu_torch.cli.preprocess calibrate --root /data/KITTI \\
        [--num_scans 20] [--device cpu]

``downsample`` writes each raw scan's 0.3 m voxel centroids (numpy, on the
host); ``pairs`` writes the ground-truth pair files, refined by ICP on the
card's radius-kNN kernel; ``calibrate`` prints the neighbour limits and band
capacities to train, test, serve and export with, computed on the card. Both
run on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse

DATASETS = ["kitti", "kitti360", "apollo", "mulran"]


def calibrate(args) -> dict:
    """Print the calibrated ``--neighbor_limits`` and ``--band_caps``."""
    import numpy as np

    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.data.calibration import calibrate_band_caps, calibrate_neighbor_limits
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset

    cfg = make_cfg()
    extra = {"demo_asset_dir": args.root} if args.subset == "infer" else {}
    dataset = RegistrationPairDataset(args.dataset, root=args.root, subset=args.subset,
                                      point_limit=cfg.train.point_limit, **extra)
    step = max(1, len(dataset) // args.num_scans)
    clouds = []
    for i in range(0, len(dataset), step):
        clouds.append(np.asarray(dataset[i]["ref_points"], np.float32))
        if len(clouds) >= args.num_scans:
            break
    limits = calibrate_neighbor_limits(clouds, cfg.pyramid, keep_ratio=args.keep_ratio,
                                       device=args.device)
    bands = calibrate_band_caps(clouds, cfg.pyramid, device=args.device)
    print(f"neighbor_limits = {limits}")
    print(f"band_caps = {bands}")
    limits_flag = ",".join(str(v) for v in limits)
    bands_flag = ",".join("none" if b is None else str(b) for b in bands)
    print("pass to rdmnet-torch-trainval / rdmnet-torch-test / rdmnet-torch-infer / "
          "rdmnet-torch-export:")
    print(f"  --neighbor_limits {limits_flag} --band_caps {bands_flag}")
    return {"neighbor_limits": limits, "band_caps": bands, "clouds": len(clouds)}


def main(argv=None):
    """Parse ``argv`` (``sys.argv`` if None) and run one subcommand; returns
    ``calibrate``'s result, or the per-sequence counts (scans downsampled or
    pair lines written)."""
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_down = sub.add_parser("downsample")
    p_down.add_argument("--dataset", default="kitti", choices=DATASETS)
    p_down.add_argument("--root", required=True)
    p_down.add_argument("--seqs", nargs="+", default=None)
    p_down.add_argument("--voxel", type=float, default=0.3)
    p_down.add_argument("--out_root", default=None)

    p_pairs = sub.add_parser("pairs")
    p_pairs.add_argument("--dataset", default="kitti", choices=DATASETS)
    p_pairs.add_argument("--root", required=True)
    p_pairs.add_argument("--seqs", nargs="+", default=None)
    p_pairs.add_argument("--thres", type=float, default=10.0)
    p_pairs.add_argument("--out_root", default=None)

    p_cal = sub.add_parser("calibrate")
    p_cal.add_argument("--dataset", default="kitti", choices=DATASETS)
    p_cal.add_argument("--root", required=True)
    p_cal.add_argument("--subset", default="train")
    p_cal.add_argument("--num_scans", type=int, default=20)
    p_cal.add_argument("--keep_ratio", type=float, default=0.8)

    for p in (p_pairs, p_cal):
        p.add_argument("--device", default="cuda",
                       help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    if args.cmd == "calibrate":
        return calibrate(args)

    from rdmnet_tpu_torch.data.datasets import SCHEMAS
    from rdmnet_tpu_torch.data.preprocess import (downsample_dataset_sequence,
                                                  generate_pairs_for_sequence)

    schema = SCHEMAS[args.dataset]
    default_seqs = list(range(11)) if args.dataset == "kitti" else list(schema.test_seqs)
    seqs = [int(s) if str(s).isdigit() else s for s in (args.seqs or default_seqs)]
    done = {}
    for seq in seqs:
        if args.cmd == "downsample":
            done[seq] = downsample_dataset_sequence(args.dataset, args.root, seq, args.voxel,
                                                    args.out_root)
            print(f"seq {seq}: downsampled {done[seq]} scans")
        else:
            done[seq] = len(generate_pairs_for_sequence(
                args.root, seq, thres=args.thres, out_root=args.out_root,
                dataset=args.dataset, device=args.device))
            print(f"seq {seq}: {done[seq]} pairs")
    return done


if __name__ == "__main__":
    main()
