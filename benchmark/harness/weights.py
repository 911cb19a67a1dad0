"""Seeded weights, drawn on the device in two large calls.

Each parameter's family follows from its name and shape, as the port
initialises them: a 2-d ``weight`` (a linear layer, out x in) is
N(0, 1/fan_in); a 3-d ``weights`` (a KPConv kernel, K x Cin x Cout) is
U(+-sqrt(1/(K Cin))); ``embeddings`` are N(0, 1); a bias is 0; a 1-d
``weight`` (a norm's scale) and the transport's ``alpha`` are 1. One normal
and one uniform draw from a CUDA generator cover every leaf."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import torch


def family(name: str, shape: Sequence[int]) -> Tuple[str, float]:
    """(draw, scale) of a parameter: ("normal" | "uniform" | "const", s)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 2:
        return "normal", 1.0 / math.sqrt(shape[1])
    if leaf == "weights" and len(shape) == 3:
        return "uniform", math.sqrt(1.0 / (shape[0] * shape[1]))
    if leaf == "embeddings":
        return "normal", 1.0
    if leaf == "bias":
        return "const", 0.0
    if leaf in ("weight", "alpha") and len(shape) <= 1:
        return "const", 1.0
    raise ValueError(f"weights: no init family for {name} of shape {tuple(shape)}")


def draw_weights(shapes: Mapping[str, Sequence[int]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``shapes`` ({name: shape}),
    the same for the same seed, whatever the order of ``shapes``."""
    shapes = {n: shapes[n] for n in sorted(shapes)}
    fams = {n: family(n, s) for n, s in shapes.items()}
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    n_normal = sum(sizes[n] for n, (d, _) in fams.items() if d == "normal")
    n_uniform = sum(sizes[n] for n, (d, _) in fams.items() if d == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i_n, i_u = {}, 0, 0
    for name, shape in shapes.items():
        draw, scale = fams[name]
        size = sizes[name]
        if draw == "normal":
            out[name] = (normal[i_n:i_n + size] * scale).reshape(shape)
            i_n += size
        elif draw == "uniform":
            out[name] = ((uniform[i_u:i_u + size] * 2 - 1) * scale).reshape(shape)
            i_u += size
        else:
            out[name] = torch.full(tuple(shape), scale, device=device)
    return out


def load_weights(model: torch.nn.Module, weights: Mapping[str, torch.Tensor]) -> None:
    """Copy ``weights`` into every parameter of ``model`` (all must be there)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(weights))
    extra = sorted(set(weights) - set(params))
    if missing or extra:
        raise ValueError(f"weights: missing {missing[:3]}, unknown {extra[:3]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
