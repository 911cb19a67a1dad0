"""Checkpoint conversion between upstream RDMNet and the port, both
directions (twin of ``rdmnet_tpu/cli/convert.py``).

Import: an upstream ``.pth.tar`` -> a snapshot of the port
(``engine/checkpoint.CheckpointManager``, with a fresh Adam state), which
every snapshot consumer then reads without converting again:

    rdmnet-torch-convert --torch_checkpoint weights/rdmnet.pth.tar \\
        --output_dir out/converted
    rdmnet-torch-test --snapshot_dir out/converted --parity_cfg ...

Export: a snapshot of the port -> a ``.pth.tar`` in the key/shape schema of
``--schema`` (any upstream checkpoint, e.g. a freshly initialised upstream
model saved once; ``div_term`` buffers are synthesised):

    rdmnet-torch-convert --snapshot_dir out/snapshots \\
        --to_torch out/rdmnet_torch.pth.tar --schema weights/rdmnet.pth.tar

Converted weights mean something only under the parity config
(``config.make_parity_cfg``: upstream's calibrated neighbour limits, a
kernel disposition per layer), so consumers pass ``--parity_cfg``; the
snapshot's metadata records ``requires_parity_cfg``. The conversion runs on
the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def convert_checkpoint(cfg, torch_checkpoint: str, output_dir: str,
                       epoch: Optional[int] = None, requires_parity_cfg: bool = True) -> int:
    """Convert ``torch_checkpoint`` into a snapshot in ``output_dir``;
    returns the snapshot's step (the checkpoint's own epoch unless given)."""
    from rdmnet_tpu_torch.cli.common import build_model_and_params
    from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager
    from rdmnet_tpu_torch.engine.train_step import create_train_state

    if epoch is None:
        blob = torch.load(torch_checkpoint, map_location="cpu", weights_only=True)
        epoch = int(blob.get("epoch", 0)) if isinstance(blob, dict) else 0
    model = build_model_and_params(cfg, device="cpu", torch_checkpoint=torch_checkpoint)
    state = create_train_state(cfg, model)
    mgr = CheckpointManager(output_dir)
    mgr.save(epoch, state, metadata={"epoch": epoch, "source": torch_checkpoint,
                                     "requires_parity_cfg": requires_parity_cfg})
    mgr.close()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"converted {torch_checkpoint} -> {output_dir} (step {epoch}, "
          f"{n_params / 1e6:.1f}M params); consume with "
          + ("--parity_cfg" if requires_parity_cfg else "the default config"))
    return epoch


def export_checkpoint(cfg, snapshot_dir: str, schema_path: str, out_path: str,
                      epoch: Optional[int] = None) -> int:
    """Write the weights of ``snapshot_dir``'s snapshot ``epoch`` (the
    latest if None) as an upstream ``.pth.tar`` in ``schema_path``'s schema;
    returns the exported epoch."""
    from rdmnet_tpu_torch.cli.common import build_model_and_params
    from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager
    from rdmnet_tpu_torch.utils.torch_convert import export_state_dict, load_torch_checkpoint

    model = build_model_and_params(cfg, snapshot_dir, epoch, device="cpu")
    schema = {k: tuple(v.shape) for k, v in load_torch_checkpoint(schema_path).items()}
    sd = export_state_dict(model.state_dict(), schema)
    if epoch is None:
        epoch = CheckpointManager(snapshot_dir).latest_step()
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": epoch},
               out_path)
    print(f"exported {snapshot_dir} -> {out_path} ({len(sd)} tensors)")
    return epoch


def main(argv=None):
    from rdmnet_tpu_torch.cli.common import add_coarse_module_flag

    parser = argparse.ArgumentParser()
    parser.add_argument("--torch_checkpoint", default=None,
                        help="import: the upstream .pth.tar to convert")
    parser.add_argument("--output_dir", default=None, help="import: the snapshot directory")
    parser.add_argument("--snapshot_dir", default=None, help="export: the snapshot to export")
    parser.add_argument("--to_torch", default=None, help="export: the .pth.tar to write")
    parser.add_argument("--schema", default=None,
                        help="export: an upstream checkpoint whose key/shape schema the export "
                             "fills")
    parser.add_argument("--epoch", type=int, default=None,
                        help="snapshot step (default: the checkpoint's own epoch, or 0; on "
                             "export the latest snapshot)")
    parser.add_argument("--no_parity_cfg", action="store_true",
                        help="build the model under the default config instead of the parity "
                             "config")
    parser.add_argument("--cfg_preset", default=None, choices=["tiny"],
                        help="'tiny' = config.make_tiny_cfg() (tests and plumbing runs only)")
    add_coarse_module_flag(parser)
    args = parser.parse_args(argv)

    import dataclasses

    from rdmnet_tpu_torch.config import make_cfg, make_parity_cfg, make_tiny_cfg

    if args.cfg_preset == "tiny":
        cfg = make_tiny_cfg()
    else:
        cfg = make_cfg() if args.no_parity_cfg else make_parity_cfg()
    if args.coarse_module is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, coarse_module=args.coarse_module))
    if args.to_torch:
        if not (args.snapshot_dir and args.schema):
            parser.error("--to_torch requires --snapshot_dir and --schema")
        return export_checkpoint(cfg, args.snapshot_dir, args.schema, args.to_torch,
                                 epoch=args.epoch)
    if not (args.torch_checkpoint and args.output_dir):
        parser.error("import requires --torch_checkpoint and --output_dir")
    return convert_checkpoint(cfg, args.torch_checkpoint, args.output_dir, epoch=args.epoch,
                              requires_parity_cfg=not args.no_parity_cfg)


if __name__ == "__main__":
    main()
