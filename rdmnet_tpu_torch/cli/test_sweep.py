"""Snapshot sweep of the port (twin of ``rdmnet_tpu/cli/test_sweep.py``;
reference experiments/test_batchoffline.py:18-327): for each epoch, N
concurrent ``rdmnet_tpu_torch.cli.test`` processes, each on a strided shard
of the pairs, dump into one feature directory; then
``rdmnet_tpu_torch.cli.eval`` runs once per method. Every worker is waited
for before judging, and any that failed raises: its shard would be missing
from the dump.

Usage:
    rdmnet-torch-test-sweep --dataset kitti --root /data/KITTI \\
        --snapshot_dir DIR --epochs 10 20 30 [--methods lgr ransac] \\
        [--num_workers 4 --worker_env CUDA_VISIBLE_DEVICES={shard}] \\
        [--worker_args '--buckets 0.7,1.0'] [--eval_args '--device cpu']

``--worker_env`` pins one worker per card on a machine with several; on
one card keep ``--num_workers 1``. On the CPU pass
``--worker_args '--device cpu'`` and ``--eval_args '--device cpu'``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="kitti")
    parser.add_argument("--root", required=True)
    parser.add_argument("--snapshot_dir", required=True)
    parser.add_argument("--epochs", type=int, nargs="+", required=True)
    parser.add_argument("--methods", nargs="+", default=["lgr", "ransac"])
    parser.add_argument("--feature_root", default="output/sweep")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--worker_env", nargs="*", default=[],
                        help="extra KEY=VALUE env per worker; '{shard}' expands to its id")
    parser.add_argument("--worker_args", default="",
                        help="extra cli.test flags for every worker, one shell-quoted string")
    parser.add_argument("--eval_args", default="",
                        help="extra cli.eval flags for every eval run")
    args = parser.parse_args(argv)

    feature_dirs = []
    for epoch in args.epochs:
        feature_dir = f"{args.feature_root}/{args.dataset}_epoch{epoch}"
        print(f"=== epoch {epoch}: dump features -> {feature_dir} ({args.num_workers} worker(s))",
              flush=True)
        procs = []
        for shard in range(args.num_workers):
            env = dict(os.environ)
            for kv in args.worker_env:
                k, _, v = kv.partition("=")
                env[k] = v.format(shard=shard)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rdmnet_tpu_torch.cli.test",
                 "--dataset", args.dataset, "--root", args.root,
                 "--snapshot_dir", args.snapshot_dir, "--test_epoch", str(epoch),
                 "--feature_dir", feature_dir,
                 "--num_shards", str(args.num_workers), "--shard_id", str(shard)]
                + shlex.split(args.worker_args),
                env=env))
        # wait for every worker: raising at the first failure would orphan
        # the others mid-write into the shared feature_dir
        rcs = [p.wait() for p in procs]
        failed = [(shard, rc) for shard, rc in enumerate(rcs) if rc != 0]
        if failed:
            raise RuntimeError(f"test worker(s) failed (shard, rc): {failed}")
        for method in args.methods:
            print(f"=== epoch {epoch}: eval method={method}", flush=True)
            subprocess.run([sys.executable, "-m", "rdmnet_tpu_torch.cli.eval",
                            "--feature_dir", feature_dir, "--method", method]
                           + shlex.split(args.eval_args), check=True)
        feature_dirs.append(feature_dir)
    return feature_dirs


if __name__ == "__main__":
    main()
