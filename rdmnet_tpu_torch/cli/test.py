"""Test-set evaluation and per-pair feature dumps of the port (twin of
``rdmnet_tpu/cli/test.py``; reference experiments/test.py:19-115): runs a
snapshot over a dataset split, logs PIR/IR/RRE/RTE/RR per pair and their
means, and writes the reference's ``.npz`` schema for ``rdmnet-torch-eval``.

Usage:
    rdmnet-torch-test --dataset kitti --root /data/KITTI [--snapshot_dir DIR]
        [--test_epoch N] [--feature_dir DIR] [--buckets 0.7,1.0] [--device cpu]
        [--torch_checkpoint F | --parity_cfg] [--coarse_module NAME]

An upstream ``.pth.tar`` (``--torch_checkpoint``) is converted at startup
and runs under the parity config unless ``--no_parity_cfg``; a snapshot
written by ``rdmnet-torch-convert`` needs ``--parity_cfg``. MulRan disables
the vote branch at inference (reference test.py:107-108).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def main(argv=None):
    """Parse ``argv`` (``sys.argv`` if None), evaluate, and return the
    ``SummaryBoard`` of the run."""
    from rdmnet_tpu_torch.cli.common import (add_model_overrides, add_pyramid_overrides,
                                             build_model_and_params, make_cli_cfg,
                                             uses_parity_cfg)
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="kitti",
                        choices=["kitti", "kitti360", "apollo", "mulran"])
    parser.add_argument("--root", required=True,
                        help="dataset root; a comma-separated list concatenates "
                             "same-schema roots")
    parser.add_argument("--snapshot_dir", default=None)
    parser.add_argument("--test_epoch", type=int, default=None)
    parser.add_argument("--feature_dir", default=None)
    parser.add_argument("--subset", default="test")
    # one process per card, each with its own --shard_id, all writing into
    # one feature_dir
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--shard_id", type=int, default=0)
    parser.add_argument("--bucket_scale", type=float, default=1.0,
                        help="pyramid capacity-bucket factor for this run (0.7 fits "
                             "typical KITTI test scans; larger scans are truncated and "
                             "count in the dropped telemetry)")
    parser.add_argument("--buckets", default=None,
                        help="comma-separated capacity-bucket factors (e.g. 0.7,1.0): "
                             "each pair runs at the smallest bucket that fits it. "
                             "Overrides --bucket_scale")
    parser.add_argument("--use_vote", default="auto", choices=["auto", "on", "off"],
                        help="vote branch at inference: auto disables it for "
                             "--dataset mulran (reference test.py:107-108)")
    add_pyramid_overrides(parser)
    add_model_overrides(parser)
    parser.add_argument("--no_compress", action="store_true",
                        help="write uncompressed .npz dumps (rdmnet-torch-eval reads both)")
    args = parser.parse_args(argv)
    if not 0 <= args.shard_id < args.num_shards:
        parser.error(f"--shard_id {args.shard_id} outside 0..{args.num_shards - 1}")

    cfg = make_cli_cfg(args)
    if uses_parity_cfg(args) and args.dataset != "kitti":
        # the parity limits are KITTI's; upstream calibrates them per dataset
        print(f"WARNING: the parity config uses KITTI-calibrated neighbor limits; for "
              f"{args.dataset} calibrate them and pass --neighbor_limits")
    vote_on = (args.dataset != "mulran") if args.use_vote == "auto" else (args.use_vote == "on")
    if not vote_on:
        cfg = dataclasses.replace(cfg, vote=dataclasses.replace(cfg.vote, inference_use_vote=False))
    cfgs = None
    if args.buckets:
        scales = sorted(float(s) for s in args.buckets.split(","))
        cfgs = [dataclasses.replace(cfg, pyramid=cfg.pyramid.scaled(s)) for s in scales]
        cfg = cfgs[-1]
    elif args.bucket_scale != 1.0:
        cfg = dataclasses.replace(cfg, pyramid=cfg.pyramid.scaled(args.bucket_scale))

    feature_dir = args.feature_dir or f"output/features{args.dataset}"
    os.makedirs(feature_dir, exist_ok=True)
    # subset "infer": the bundled demo pairs, read from --root
    extra = {"demo_asset_dir": args.root} if args.subset == "infer" else {}
    dataset = RegistrationPairDataset(args.dataset, root=args.root, subset=args.subset,
                                      point_limit=cfg.test.point_limit, **extra)
    model = build_model_and_params(cfg, args.snapshot_dir, args.test_epoch, device=args.device,
                                   torch_checkpoint=args.torch_checkpoint)
    indices = list(range(args.shard_id, len(dataset), args.num_shards))
    board = run_eval_loop(cfg, model, dataset, indices, feature_dir,
                          compress=not args.no_compress, cfgs=cfgs, device=args.device)
    print("== summary ==")
    print(board.format())
    return board


def _make_eval_forward(cfg, model, evaluator, dev):
    """Padded pair -> (outputs, metrics): the graph build at ``cfg.pyramid``,
    the model with ground truth, the Evaluator and ``dropped`` (points or
    voxels the pyramid's capacities cut)."""
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch
    from rdmnet_tpu_torch.models import with_pyramid

    view = with_pyramid(model, cfg.pyramid)

    @torch.no_grad()
    def forward(rp, rc, sp, sc, transform):
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        batch = build_pair_batch(f32(rp), i32(rc), f32(sp), i32(sc), f32(transform), cfg.pyramid)
        out = view(batch, training=False, with_gt=True)
        metrics = evaluator(out, batch, evaling=True)
        metrics["dropped"] = (batch.ref.dropped.sum() + batch.src.dropped.sum()).float()
        return out, metrics

    return forward


def run_eval_loop(cfg, model, dataset, indices, feature_dir, compress=True, log=print,
                  cfgs=None, device=None):
    """Dump features and metrics for ``indices`` of ``dataset`` on ``device``
    (CUDA unless told otherwise). Returns the ``SummaryBoard``.

    One pair in flight: pair i+1's forward is issued before pair i's outputs
    are read back and trimmed, and the ``.npz`` writes run on two worker
    threads (host arrays only), at most four queued.

    ``cfgs``: capacity-bucket variants of ``cfg`` (the same model at other
    ``pyramid`` caps); each pair runs at the smallest that fits both
    clouds."""
    from rdmnet_tpu_torch.cli.common import pad_pair_np, trim_outputs
    from rdmnet_tpu_torch.data.loader import choose_bucket
    from rdmnet_tpu_torch.device import resolve_device
    from rdmnet_tpu_torch.engine.meters import SummaryBoard, Timer, to_floats
    from rdmnet_tpu_torch.losses import Evaluator

    dev = resolve_device(device)
    evaluator = Evaluator(cfg)
    cfgs = sorted(cfgs or [cfg], key=lambda c: c.pyramid.caps[0])
    caps = [c.pyramid.caps[0] for c in cfgs]
    forwards = [_make_eval_forward(c, model, evaluator, dev) for c in cfgs]

    board = SummaryBoard()
    timer = Timer()
    timer.tic()
    savez = np.savez_compressed if compress else np.savez
    writes = []

    def finalize(pending, n_done):
        out, metrics, item, trunc0, cap, prep_s, proc_s = pending
        metrics = to_floats(metrics)
        metrics["dropped"] += trunc0
        board.update_from_dict(metrics)
        dumped = trim_outputs(out, item["transform"])
        name = f"{item['seq_id']}_{item['src_frame']}_{item['ref_frame']}"
        writes.append(writer.submit(savez, osp.join(feature_dir, name + ".npz"), **dumped))
        # each queued write holds a whole dump: wait on the oldest past four
        while len(writes) > 4:
            writes.pop(0).result()
        bucket = f" | cap {cap}" if len(caps) > 1 else ""
        log(f"[{n_done}/{len(indices)}] {name} | "
            + ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
            + f" | prep {prep_s:.3f}s proc {proc_s:.3f}s" + bucket)

    with ThreadPoolExecutor(max_workers=2, thread_name_prefix="npz") as writer:
        pending = None
        for n_done, i in enumerate(indices):
            item = dataset[i]
            bi = choose_bucket(max(len(item["ref_points"]), len(item["src_points"])), caps)
            rp, rc, sp, sc = pad_pair_np(cfgs[bi], item["ref_points"], item["src_points"])
            trunc0 = (max(0, len(item["ref_points"]) - len(rp))
                      + max(0, len(item["src_points"]) - len(sp)))
            timer.record_prepare()
            out, metrics = forwards[bi](rp, rc, sp, sc, item["transform"])
            timer.record_process()
            if pending is not None:
                finalize(pending, n_done)
            # this pair's own intervals ride with it to its log line, one
            # iteration later
            pending = (out, metrics, item, trunc0, caps[bi],
                       timer.last_prepare(), timer.last_process())
        if pending is not None:
            finalize(pending, len(indices))
        for w in writes:
            w.result()  # a failed write raises here
    return board


if __name__ == "__main__":
    main()
