"""Upstream RDMNet checkpoints <-> the port's ``state_dict``, both directions
(twin of ``rdmnet_tpu/utils/torch_convert.py``).

``convert_state_dict`` maps the upstream ``state_dict`` key schema (a
``.pth.tar``'s ``"model"``) onto the port's keys; the result loads into
``RDMNet`` with ``strict=True``. ``export_state_dict`` fills a given
upstream ``{key: shape}`` schema from a port model. The rules (one source,
``port_key_and_kind``):

* the conditional transformer's ``layers.N`` alternate rotary self and
  vanilla cross layers: ``layers.{2l}`` -> ``self_{l}``,
  ``layers.{2l+1}`` -> ``cross_{l}``;
* upstream nests the attention's projections one level deeper
  (``attention.attention.proj_q``) and its output linear and norm inside
  the attention sub-layer (``attention.linear``): both are flattened;
* ``norm.norm`` / ``norm_conv.norm`` (the GroupNorm wrapper),
  ``transformer.transformer`` / ``transformer2.transformer`` (the stack
  inside ThDRoFormer) and ``embedding.proj`` collapse to one level;
* the vote MLP's ``mlp_modules.{0,3}`` are ``mlp_{0,1}``,
  ``mlp_modules.{1,4}`` ``mlp_norm_{0,1}``, ``out_proj.*`` ``out_norm``;
* ``div_term`` buffers are dropped on import and synthesised on export,
  sinusoidal (1-D) or rotary ((1, 1, 1, d));
* ``kernel_points`` are kept verbatim: upstream draws each KPConv layer's
  kernel disposition at build time, and trained weights mean something
  only with their own kernel points (use ``config.make_parity_cfg``).

Torch ``Linear`` weights keep their (out, in) layout on both sides, so no
value is transposed. The rules are many-to-one (a collapse cannot be undone
from the port's keys alone), so export needs the upstream schema.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Sequence, Tuple, Union

import numpy as np
import torch


def _map_transformer_key(parts, prefix):
    """['layers', N, ...] of a conditional transformer -> the port's path."""
    idx = int(parts[1])
    layer_name = f"self_{idx // 2}" if idx % 2 == 0 else f"cross_{idx // 2}"
    rest = parts[2:]
    if rest[0] == "attention" and rest[1] == "attention":
        return prefix + [layer_name, "attention"] + rest[2:]
    if rest[0] == "attention":
        # linear / norm of the attention sub-layer sit on the layer itself
        return prefix + [layer_name] + rest[1:]
    return prefix + [layer_name] + rest


def port_key_and_kind(key: str) -> Tuple[str, str]:
    """Upstream ``state_dict`` key -> (the port's key, kind): kind is
    ``"div_term"`` for a regenerated buffer, else ``"verbatim"``."""
    if ".transformer.layers." in key or re.match(r"transformer2?\.layers\.", key):
        head, _, tail = key.partition(".layers.")
        path = _map_transformer_key(["layers"] + tail.split("."), head.split("."))
    else:
        path = key.split(".")
    kind = "div_term" if path[-1] == "div_term" else "verbatim"

    collapsed = []
    for p in path:
        if collapsed and (
            (p == "norm" and collapsed[-1] in ("norm", "norm_conv"))
            or (p == "transformer" and collapsed[-1] in ("transformer", "transformer2"))
            or (p == "proj" and collapsed[-1] == "embedding")
        ):
            continue
        collapsed.append(p)
    path = collapsed
    if path[0] == "vote" and len(path) > 1 and path[1] == "mlp_modules":
        seq = int(path[2])
        sub = "mlp" if seq % 3 == 0 else "mlp_norm"
        path = ["vote", f"{sub}_{seq // 3}"] + path[3:]
    if path[0] == "vote" and len(path) > 1 and path[1] == "out_proj":
        path = ["vote", "out_norm"] + path[3:]
    return ".".join(path), kind


def _strip_module(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def convert_state_dict(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Upstream ``state_dict`` (tensors or arrays, ``module.`` prefixes
    allowed) -> the port's ``state_dict`` of float32 host tensors."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        name, kind = port_key_and_kind(_strip_module(key))
        if kind == "div_term":
            continue
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


def _div_term(shape: Tuple[int, ...]) -> np.ndarray:
    if len(shape) == 1:
        # sinusoidal: exp(arange(0, d, 2) * (-ln 1e4 / d)), d = 2 * len
        d_model = 2 * shape[0]
        return np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * np.float32(-np.log(10000.0) / d_model))
    # rotary: the per-head sinusoidal term, each entry twice, as (1, 1, 1, d)
    d = shape[-1]
    base = np.exp(np.arange(0, d, 2, dtype=np.float32) * np.float32(-np.log(10000.0) / d))
    return np.repeat(base, 2).reshape(shape)


def export_state_dict(model_state: Mapping[str, torch.Tensor],
                      schema: Union[Mapping[str, Sequence[int]], Iterable[str]]
                      ) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> an upstream ``state_dict`` (numpy) with
    exactly the keys of ``schema``: a ``{key: shape}`` mapping, or a key
    iterable when it holds no ``div_term``. A key with no counterpart in the
    model raises ``KeyError``, a shape that differs ``ValueError``."""
    if not isinstance(schema, Mapping):
        schema = {k: None for k in schema}
    out: Dict[str, np.ndarray] = {}
    for key, shape in schema.items():
        name, kind = port_key_and_kind(_strip_module(key))
        if kind == "div_term":
            if shape is None:
                raise ValueError(f"{key}: div_term synthesis needs the target shape")
            out[key] = _div_term(tuple(int(s) for s in shape))
            continue
        if name not in model_state:
            raise KeyError(f"{key}: the model has no {name}")
        v = model_state[name].detach().cpu().numpy()
        if shape is not None and tuple(v.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {tuple(v.shape)} in the model, "
                             f"{tuple(shape)} in the schema")
        out[key] = np.array(v, dtype=np.float32, order="C")
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """An upstream ``.pth.tar`` (its ``"model"`` or ``"state_dict"``, or a
    bare state dict) as numpy arrays, ``module.`` prefixes stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("model", blob.get("state_dict", blob)) if isinstance(blob, dict) else blob
    return {_strip_module(k): v.detach().cpu().numpy() for k, v in state.items()}
