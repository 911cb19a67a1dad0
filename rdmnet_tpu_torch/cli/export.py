"""Export the port's model as a serving artifact (twin of
``rdmnet_tpu/cli/export.py``).

Usage:
    rdmnet-torch-export --out_dir output/export [--snapshot_dir DIR [--test_epoch N]]
                        [--buckets 0.5,0.7,1.0] [--check --asset_dir DIR] [--device cpu]

The artifact (``weights.npz`` in the JAX artifact's layout + ``serving.json``,
see ``rdmnet_tpu_torch/serving.py``) holds a snapshot's weights, or weights
drawn from the config's seed without one. ``--check`` reloads it, registers the demo pair
``000000.npy``/``000004.npy`` of ``--asset_dir`` through it and compares the
pose with the live ``pipeline`` at the bucket the request was dispatched to.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from rdmnet_tpu_torch.cli.common import add_pyramid_overrides

    parser = argparse.ArgumentParser()
    add_pyramid_overrides(parser)
    parser.add_argument("--out_dir", default="output/export")
    parser.add_argument("--snapshot_dir", default=None)
    parser.add_argument("--test_epoch", type=int, default=None)
    parser.add_argument(
        "--buckets", default="1.0",
        help="comma-separated capacity-bucket scale factors (e.g. 0.5,0.7,1.0) over "
             "shared weights; the server dispatches each request to the smallest "
             "bucket that fits",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="run the demo pair of --asset_dir through the reloaded artifact and "
             "compare its pose against the live pipeline",
    )
    parser.add_argument("--asset_dir", default=None,
                        help="directory holding 000000.npy and 000004.npy (--check)")
    args = parser.parse_args(argv)
    if args.check and not args.asset_dir:
        parser.error("--check needs --asset_dir")

    from rdmnet_tpu_torch.cli.common import build_model_and_params, make_cli_cfg
    from rdmnet_tpu_torch.serving import export_inference, load_exported

    cfg = make_cli_cfg(args)
    model = build_model_and_params(cfg, args.snapshot_dir, args.test_epoch, device=args.device)
    bucket_scales = tuple(float(s) for s in args.buckets.split(",") if s.strip())
    buckets = export_inference(cfg, model, args.out_dir, bucket_scales=bucket_scales)
    print(f"exported: {args.out_dir} (buckets={args.buckets}, caps="
          f"{','.join(str(b['cap']) for b in buckets)})")

    if args.check:
        import os.path as osp

        from rdmnet_tpu_torch.cli.common import pad_pair_np
        from rdmnet_tpu_torch.models import pipeline, with_pyramid

        serve, _ = load_exported(args.out_dir, device=args.device)
        ref = np.load(osp.join(args.asset_dir, "000000.npy"))[:, :3]
        src = np.load(osp.join(args.asset_dir, "000004.npy"))[:, :3]
        out = serve(ref, src)
        est = out["estimated_transform"]

        # the live pipeline at the SAME capacity bucket the artifact
        # dispatched to (padded shapes enter the graph build)
        cfg_check = next(b["cfg"] for b in buckets if b["cap"] == serve.last_cap)
        live = pipeline(with_pyramid(model, cfg_check.pyramid),
                        *pad_pair_np(cfg_check, ref, src), device=args.device)
        delta = float(np.abs(est - live["estimated_transform"].cpu().numpy()).max())
        n_corr = int((out["corr_scores"] > 0).sum())
        print(f"check: bucket {serve.last_cap}, {n_corr} correspondences, "
              f"|pose - live|_max = {delta:.2e}")
        if not delta < 1e-4:
            raise SystemExit("check: exported artifact diverges from the live pipeline")
        print("check: OK")


if __name__ == "__main__":
    main()
