"""Host batches to pyramids on the device (twin of ``batch_to_device`` in
``rdmnet_tpu/engine/trainer.py``; the ``Trainer`` loop is not ported yet)."""

from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch

from rdmnet_tpu_torch.config import PyramidConfig
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.graph.pyramid import PairBatch, build_pair_batch


@torch.no_grad()
def batch_to_device(np_batch: Mapping, spec: PyramidConfig, device=None) -> List[PairBatch]:
    """A host batch of padded pairs -> one ``PairBatch`` per pair, its
    pyramid built on the device (the radius-kNN kernel on the card).

    ``np_batch`` holds ``ref_points``/``src_points`` (B, cap_0, 3),
    ``ref_counts``/``src_counts`` (B,), ``transform`` (B, 4, 4) and optional
    ``ref_dropped``/``src_dropped`` (B,) host truncation counts. Runs on CUDA
    unless ``device`` names another device; raises without a card."""
    dev = resolve_device(device)
    bsz = len(np_batch["ref_points"])
    zeros = np.zeros(bsz, np.int32)
    ref_dropped = np.asarray(np_batch.get("ref_dropped", zeros))
    src_dropped = np.asarray(np_batch.get("src_dropped", zeros))

    def put(key, b, dtype):
        return torch.tensor(np.asarray(np_batch[key][b]), dtype=dtype, device=dev)

    return [build_pair_batch(put("ref_points", b, torch.float32), put("ref_counts", b, torch.int32),
                             put("src_points", b, torch.float32), put("src_counts", b, torch.int32),
                             put("transform", b, torch.float32), spec,
                             ref_dropped0=int(ref_dropped[b]), src_dropped0=int(src_dropped[b]))
            for b in range(bsz)]
