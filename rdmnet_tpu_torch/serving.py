"""Serving export of the port (twin of ``rdmnet_tpu/serving.py``).

``export_inference`` writes an artifact directory that ``load_exported``
turns into a ready-to-call ``serve(ref_points, src_points)``:

* ``weights.npz``  — the parameters in the JAX artifact's layout exactly
  (``w{i}`` in ``jax.tree_util.tree_flatten`` order of the flax tree, see
  ``utils/convert.py``), shared by all capacity buckets;
* ``serving.json`` — the JAX artifact's keys (``cap``, ``buckets[].cap``,
  ``n_weights``, ``outputs``, ``pad_coord``) plus the port's ``config`` and
  each bucket's ``scale``.

The JAX export lowers each bucket's pipeline (build, forward, LGR) to one
static-shape StableHLO program. The port's program per bucket is a CUDA
graph, made at load: ``load_exported`` builds the model once on the card,
takes each bucket's view of it (``models.with_pyramid``, all buckets over one
copy of the weights) and captures its ``pipeline`` once
(``models.capture_pipeline``), every bucket's graph in one shared memory
pool; a request is padded on the host, copied into the program's inputs,
replayed and fetched once, with no Python model code and no host round trip
inside. The artifact's files hold no program, so an artifact written by the
JAX package (StableHLO beside the same ``weights.npz``) serves too when the
caller passes its ``cfg`` and ``bucket_scales``. On the CPU the buckets run
``pipeline`` eagerly. Consumers filter correspondences by ``corr_scores >
0``, as with the JAX artifact.

Traced (``trace``, while a profile records): each request is a ``serve``
span with the children ``serve.pad``, ``serve.stage``, ``serve.launch``
(copies in, the replay and the fetch's copies), ``serve.wait`` (the one
synchronise) and ``serve.unpack``, and adds to the counters
``serve.bucket.<cap>``, ``serve.rows`` (valid rows), ``serve.capacity_rows``
(2 x cap), ``serve.truncated_rows`` (rows past cap), ``pipeline.dropped``
and ``pipeline.nms_rounds`` (the program's ``TELEMETRY``, fetched with the
outputs only then).
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rdmnet_tpu_torch import trace
from rdmnet_tpu_torch.data.loader import pad_points_np

SERVE_OUTPUTS = (
    "estimated_transform",
    "ref_corr_points",
    "src_corr_points",
    "corr_scores",
)
TELEMETRY = ("dropped", "nms_rounds")  # fetched for the counters while a profile records

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


def _count_request(cap: int, rows: int, n_ref: int, n_src: int, dropped: np.ndarray,
                  nms_rounds: np.ndarray) -> None:
    """A served request's counters (module docstring)."""
    trace.count(f"serve.bucket.{cap}")
    trace.count("serve.rows", int(rows))
    trace.count("serve.capacity_rows", 2 * cap)
    trace.count("serve.truncated_rows", max(0, n_ref - cap) + max(0, n_src - cap))
    trace.count("pipeline.dropped", int(np.sum(dropped)))
    trace.count("pipeline.nms_rounds", int(np.sum(nms_rounds)))


def load_exported(out_dir: str, device=None, cfg=None,
                  bucket_scales: Optional[Sequence[float]] = None):
    """Rebuild a callable from an artifact directory on ``device`` (CUDA
    unless told otherwise; raises without a card).

    Returns ``(serve, meta)``. ``serve(ref_points, src_points)`` takes raw
    (N, >=3) clouds, pads or truncates them on the host to the smallest
    bucket that fits both (the largest otherwise), runs that bucket's
    program and returns a numpy dict of ``SERVE_OUTPUTS`` in their padded
    shapes; ``serve.last_cap`` is the bucket that served the last request.
    On the card every bucket's ``pipeline`` is captured here, at load, as a
    CUDA graph (``models.capture_pipeline``) over one shared graph memory
    pool, and a request replays its bucket's graph under a lock (copy in,
    replay, one fetch), so concurrent callers (``cli/serve.py``'s threads)
    are safe; a capture that fails raises. ``serve.programs`` maps each
    capacity to its program (``launches``, ``capture_s``). On the CPU every
    request runs ``pipeline`` eagerly.

    ``cfg`` and ``bucket_scales`` default to the artifact's own (its config
    names the coarse family, ``k2`` and the vote settings); an artifact of
    the JAX package has neither, so the caller passes the config (family
    included) and the scales it was exported with. Raises if a bucket's capacity differs from
    the artifact's.
    """
    import torch

    from rdmnet_tpu_torch.config import Config, config_from_dict
    from rdmnet_tpu_torch.device import resolve_device
    from rdmnet_tpu_torch.models import RDMNet, capture_pipeline, pipeline, with_pyramid
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
    views = [(b["cap"], with_pyramid(model, b["cfg"].pyramid)) for b in buckets]
    programs: Dict[int, object] = {}
    fetched: Dict[int, Dict[str, torch.Tensor]] = {}
    if dev.type == "cuda":
        pool = torch.cuda.graph_pool_handle()
        # largest bucket first: the smaller captures then reuse the blocks it freed in
        # the shared pool (captured smallest first, each needs larger blocks anew)
        programs = {cap: capture_pipeline(view, dev, pool=pool) for cap, view in views[::-1]}
        torch.cuda.empty_cache()  # the warm-ups' cached blocks; the graphs' pool stays
        # pinned host copies of each program's outputs, so a request fetches once
        fetched = {cap: {k: torch.empty(run.outputs[k].shape, dtype=run.outputs[k].dtype,
                                        pin_memory=True) for k in SERVE_OUTPUTS + TELEMETRY}
                   for cap, run in programs.items()}
    lock = threading.Lock()

    def serve(ref_points: np.ndarray, src_points: np.ndarray) -> Dict[str, np.ndarray]:
        with trace.span("serve"):
            return request(ref_points, src_points)

    def request(ref_points, src_points) -> Dict[str, np.ndarray]:
        with trace.span("serve.pad"):
            n = max(len(ref_points), len(src_points))
            # smallest bucket that fits; largest (with truncation) otherwise
            cap, model_b = next((b for b in views if n <= b[0]), views[-1])
            rp, rc = _pad_np(np.asarray(ref_points, np.float32), cap)
            sp, sc = _pad_np(np.asarray(src_points, np.float32), cap)
        recording = trace.recording()
        keys = SERVE_OUTPUTS + TELEMETRY if recording else SERVE_OUTPUTS
        with lock:  # one request at a time: a replay overwrites the program's outputs
            serve.last_cap = cap  # observability: which bucket served the request
            if programs:
                run, host = programs[cap], fetched[cap]
                with trace.span("serve.stage"):
                    run.stage(rp, rc, sp, sc)
                with trace.span("serve.launch"):
                    out = run.launch()
                    for k in keys:
                        host[k].copy_(out[k], non_blocking=True)
                with trace.span("serve.wait"):
                    torch.cuda.current_stream(dev).synchronize()
            else:
                with trace.span("serve.stage"):
                    args = (torch.from_numpy(rp), rc, torch.from_numpy(sp), sc)
                with trace.span("serve.launch"):
                    host = pipeline(model_b, *args, device=dev)
                with trace.span("serve.wait"):
                    pass  # the CPU's pipeline has finished when it returns
            with trace.span("serve.unpack"):
                result = {k: host[k].numpy().copy() for k in SERVE_OUTPUTS}
                if recording:
                    _count_request(cap, rc + sc, len(ref_points), len(src_points),
                                  *(host[k].numpy() for k in TELEMETRY))
        return result

    serve.last_cap = None
    serve.model = model
    serve.programs = programs
    return serve, meta
