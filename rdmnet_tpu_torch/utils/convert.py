"""Weights of the JAX package -> a ``state_dict`` of the port's ``RDMNet``.

The port names its submodules after the flax parameter tree, so conversion
is a tree walk: the path joins with "." and each leaf maps by name —
Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), transposed; norm
``scale`` -> ``weight``; ``bias``, KPConv ``weights`` and ``kernel_points``
and the dustbin ``alpha`` verbatim. The result loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays, with or without the
    top-level ``"params"`` collection) -> torch state_dict."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name == "scale":
                name = "weight"
            state[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, "")
    return state
