"""Training CLI of the port (twin of ``rdmnet_tpu/cli/trainval.py``;
reference experiments/trainval.py:15-69): trains on the train split,
validates each epoch, keeps per-epoch and best-validation snapshots.

Usage:
    rdmnet-torch-trainval --root /data/KITTI_odometry [--output_dir DIR]
        [--resume] [--max_epoch N] [--device cpu] [--cfg_preset tiny]

One device (CUDA unless ``--device cpu``); data parallelism is not ported
yet. ``--coarse_module`` picks the coarse transformer family.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    """Parse ``argv`` (``sys.argv`` if None), train, and return the
    ``Trainer``."""
    from rdmnet_tpu_torch.cli.common import (add_coarse_module_flag, add_pyramid_overrides,
                                             make_cli_cfg)
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset
    from rdmnet_tpu_torch.data.loader import PairLoader
    from rdmnet_tpu_torch.engine.trainer import Trainer

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="kitti")
    parser.add_argument("--root", required=True,
                        help="dataset root; a comma-separated list concatenates "
                             "same-schema roots")
    parser.add_argument("--output_dir", default="output/rdmnet_tpu_torch")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None,
                        help="base learning rate (default: Adam 1e-4, the reference's)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--keep_snapshots", type=int, default=None,
                        help="keep only the newest N epoch snapshots (default: all)")
    parser.add_argument("--no_augmentation", action="store_true",
                        help="disable train-time augmentation")
    parser.add_argument("--augmentation_rotation", type=float, default=None,
                        help="rotation-augmentation factor: euler angles up to "
                             "2*pi/factor (1.0 = full rotations)")
    parser.add_argument("--augmentation_scale", default=None,
                        help="global-scale augmentation range as MIN,MAX (default "
                             "0.8,1.2); '1,1' disables scaling")
    parser.add_argument("--augmentation_shift", type=float, default=None,
                        help="per-cloud random-shift bound in meters (default 2.0)")
    parser.add_argument("--augmentation_noise", type=float, default=None,
                        help="uniform point-jitter amplitude in meters (default 0.01)")
    parser.add_argument("--init_from", default=None,
                        help="warm-start the weights from another run's snapshot dir "
                             "(e.g. <run>/snapshots_best) with a fresh optimizer and "
                             "schedule; ignored with --resume")
    parser.add_argument("--grad_acc", type=int, default=None,
                        help="gradient-accumulation micro-steps per applied update")
    parser.add_argument("--bucket_scale", type=float, default=1.0,
                        help="pyramid capacity-bucket factor for the whole run (0.7 "
                             "fits typical KITTI scans)")
    add_pyramid_overrides(parser)
    add_coarse_module_flag(parser)
    parser.add_argument("--scheduler", default=None, choices=["step", "warmup_cosine"],
                        help="LR schedule family: step decay (default) or warmup-cosine")
    parser.add_argument("--warmup_steps", type=int, default=None,
                        help="warmup micro-steps for --scheduler warmup_cosine")
    args = parser.parse_args(argv)

    cfg = make_cli_cfg(args)
    optim, train = {}, {}
    if args.max_epoch is not None:
        optim["max_epoch"] = args.max_epoch
    if args.lr is not None:
        optim["lr"] = args.lr
    if args.grad_acc is not None:
        optim["grad_acc_steps"] = args.grad_acc
    if args.scheduler is not None:
        optim["scheduler"] = args.scheduler
    if args.warmup_steps is not None:
        optim["warmup_steps"] = args.warmup_steps
    if args.no_augmentation:
        train["use_augmentation"] = False
    if args.augmentation_rotation is not None:
        train["augmentation_rotation"] = args.augmentation_rotation
    if args.augmentation_scale is not None:
        lo, hi = (float(v) for v in args.augmentation_scale.split(","))
        train.update(augmentation_min_scale=lo, augmentation_max_scale=hi)
    if args.augmentation_shift is not None:
        train["augmentation_shift"] = args.augmentation_shift
    if args.augmentation_noise is not None:
        train["augmentation_noise"] = args.augmentation_noise
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, **optim),
                              train=dataclasses.replace(cfg.train, **train))
    if args.bucket_scale != 1.0:
        cfg = dataclasses.replace(cfg, pyramid=cfg.pyramid.scaled(args.bucket_scale))
    batch_size = args.batch_size or cfg.train.batch_size

    t = cfg.train
    train_dataset = RegistrationPairDataset(
        args.dataset, root=args.root, subset="train", point_limit=t.point_limit,
        use_augmentation=t.use_augmentation, augmentation_noise=t.augmentation_noise,
        augmentation_min_scale=t.augmentation_min_scale,
        augmentation_max_scale=t.augmentation_max_scale,
        augmentation_shift=t.augmentation_shift,
        augmentation_rotation=t.augmentation_rotation, seed=cfg.seed)
    val_dataset = RegistrationPairDataset(args.dataset, root=args.root, subset="val",
                                          point_limit=t.point_limit)
    cap = cfg.pyramid.caps[0]
    train_loader = PairLoader(train_dataset, cap=cap, batch_size=batch_size, shuffle=True,
                              drop_last=True, seed=cfg.seed)
    val_loader = PairLoader(val_dataset, cap=cap, batch_size=batch_size)

    trainer = Trainer(cfg, train_loader, val_loader, output_dir=args.output_dir,
                      log_steps=args.log_steps, keep_snapshots=args.keep_snapshots,
                      device=args.device)
    if args.init_from and not args.resume:
        trainer.warm_start(args.init_from)
    trainer.run(resume=args.resume)
    return trainer


if __name__ == "__main__":
    main()
