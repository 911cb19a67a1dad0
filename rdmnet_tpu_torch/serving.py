"""Serving export of the port (twin of ``rdmnet_tpu/serving.py``).

``export_inference`` writes an artifact directory that ``load_exported``
turns into a ready-to-call ``serve(ref_points, src_points)``:

* ``weights.npz``  — the parameters in the JAX artifact's layout exactly
  (``w{i}`` in ``jax.tree_util.tree_flatten`` order of the flax tree, see
  ``utils/convert.py``), shared by all capacity buckets;
* ``serving.json`` — the JAX artifact's keys (``cap``, ``buckets[].cap``,
  ``n_weights``, ``outputs``, ``pad_coord``) plus the port's ``config`` and
  each bucket's ``scale``.

There is no compiled program: the port's program is its model code, so a
bucket is the model with that bucket's pyramid (``models.with_pyramid``),
all buckets over one copy of the weights on the device. An artifact written
by the JAX package (StableHLO beside the same ``weights.npz``) serves too
when the caller passes its ``cfg`` and ``bucket_scales``. Consumers filter
correspondences by ``corr_scores > 0``, as with the JAX artifact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rdmnet_tpu_torch.data.loader import pad_points_np

SERVE_OUTPUTS = (
    "estimated_transform",
    "ref_corr_points",
    "src_corr_points",
    "corr_scores",
)

PAD_COORD = 1.0e9  # data/loader.pad_points_np convention


def _pad_np(points: np.ndarray, cap: int) -> Tuple[np.ndarray, np.int32]:
    return pad_points_np(points[:, :3], cap, PAD_COORD)


def bucket_configs(cfg, bucket_scales: Sequence[float]) -> List[dict]:
    """``[{"cap", "scale", "cfg"}, ...]`` ascending by capacity, one per
    distinct level-0 capacity, as the JAX export forms its buckets (1.0 is
    the config's own pyramid, others ``cfg.pyramid.scaled(scale)``)."""
    buckets: List[dict] = []
    for scale in sorted(set(float(s) for s in bucket_scales)):
        cfg_b = cfg if scale == 1.0 else dataclasses.replace(
            cfg, pyramid=cfg.pyramid.scaled(scale))
        cap = int(cfg_b.pyramid.caps[0])
        if any(b["cap"] == cap for b in buckets):
            continue  # scales rounding to the same capacity
        buckets.append({"cap": cap, "scale": scale, "cfg": cfg_b})
    return sorted(buckets, key=lambda b: b["cap"])


def export_inference(cfg, model, out_dir: str,
                     bucket_scales: Sequence[float] = (1.0,)) -> List[dict]:
    """Write ``model``'s serving artifact for the buckets ``bucket_scales``
    (factors of ``cfg.pyramid.scaled``). Returns the bucket list
    ``[{"cap", "scale", "cfg"}, ...]`` ascending by capacity."""
    from rdmnet_tpu_torch.utils.convert import flatten_params

    buckets = bucket_configs(cfg, bucket_scales)
    flat = flatten_params(model)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(osp.join(out_dir, "weights.npz"), **{f"w{i}": x for i, x in enumerate(flat)})
    meta = {
        "cap": buckets[-1]["cap"],  # largest bucket (truncation capacity)
        "buckets": [{"cap": b["cap"], "scale": b["scale"]} for b in buckets],
        "n_weights": len(flat),
        "outputs": list(SERVE_OUTPUTS),
        "pad_coord": PAD_COORD,
        "config": dataclasses.asdict(cfg),
    }
    with open(osp.join(out_dir, "serving.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return buckets


def load_exported(out_dir: str, device=None, cfg=None,
                  bucket_scales: Optional[Sequence[float]] = None):
    """Rebuild a callable from an artifact directory on ``device`` (CUDA
    unless told otherwise; raises without a card).

    Returns ``(serve, meta)``. ``serve(ref_points, src_points)`` takes raw
    (N, >=3) clouds, pads or truncates them on the host to the smallest
    bucket that fits both (the largest otherwise), runs ``pipeline`` there
    and returns a numpy dict of ``SERVE_OUTPUTS`` in their padded shapes;
    ``serve.last_cap`` is the bucket that served the last request.

    ``cfg`` and ``bucket_scales`` default to the artifact's own (its config
    names the coarse family, ``k2`` and the vote settings); an artifact of
    the JAX package has neither, so the caller passes the config (family
    included) and the scales it was exported with. Raises if a bucket's capacity differs from
    the artifact's.
    """
    from rdmnet_tpu_torch.config import Config, config_from_dict
    from rdmnet_tpu_torch.device import resolve_device
    from rdmnet_tpu_torch.models import RDMNet, pipeline, with_pyramid
    from rdmnet_tpu_torch.utils.convert import load_flat_params

    dev = resolve_device(device)
    with open(osp.join(out_dir, "serving.json")) as f:
        meta = json.load(f)
    stored = meta.get("buckets") or [{"cap": meta["cap"]}]
    if cfg is None:
        if "config" not in meta:
            raise ValueError(f"{out_dir} holds no config (an artifact of the JAX package): "
                             "pass cfg and bucket_scales")
        cfg = config_from_dict(Config, meta["config"])
    if bucket_scales is None:
        if any("scale" not in b for b in stored):
            raise ValueError(f"{out_dir} holds no bucket scales: pass bucket_scales")
        bucket_scales = [b["scale"] for b in stored]
    buckets = bucket_configs(cfg, bucket_scales)
    caps = [int(b["cap"]) for b in stored]
    if [b["cap"] for b in buckets] != caps:
        raise ValueError(f"bucket capacities {[b['cap'] for b in buckets]} from the config "
                         f"and scales {list(bucket_scales)} differ from the artifact's {caps}")

    weights = np.load(osp.join(out_dir, "weights.npz"))
    # built on the device (which checks the config against the kernels'
    # limits) and loaded once; every bucket is a view over the same tensors
    model = RDMNet(cfg, device=dev)
    load_flat_params(model, [weights[f"w{i}"] for i in range(meta["n_weights"])])
    calls = [(b["cap"], with_pyramid(model, b["cfg"].pyramid)) for b in buckets]

    def serve(ref_points: np.ndarray, src_points: np.ndarray) -> Dict[str, np.ndarray]:
        n = max(len(ref_points), len(src_points))
        # smallest bucket that fits; largest (with truncation) otherwise
        cap, model_b = next((b for b in calls if n <= b[0]), calls[-1])
        serve.last_cap = cap  # observability: which bucket served the request
        rp, rc = _pad_np(np.asarray(ref_points, np.float32), cap)
        sp, sc = _pad_np(np.asarray(src_points, np.float32), cap)
        out = pipeline(model_b, rp, rc, sp, sc, device=dev)
        return {k: out[k].cpu().numpy() for k in SERVE_OUTPUTS}

    serve.last_cap = None
    serve.model = model
    return serve, meta
