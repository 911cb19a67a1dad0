"""Layer factory and the Conv/Linear -> Norm -> Act block
(twin of ``rdmnet_tpu/nn/layers.py``).

A string or ``{"type": ..., **kwargs}`` config builds an activation, a
dropout or a norm; ``ConvBlock`` assembles them behind a Linear or a
Conv{1,2,3}d. Library surface: the RDMNet backbone builds its blocks in
``nn/kpconv.py`` and calls none of this.

* Inputs are channel-last ((..., C): NWC, NHWC, NDHWC), as the JAX package's;
  the convolutions move the channel axis for torch and back.
* Config keywords are flax's (``epsilon``, ``use_scale``, ``use_bias``,
  ``momentum``, ``num_groups``), so one config drives both packages.
* Submodules carry flax's names (``Dense_0``, ``Conv_0``, ``GroupNorm_0``,
  ``LayerNorm_0``, ``BatchNorm_0``), so ``utils/convert.py`` carries weights
  and batch statistics across by a tree walk.
* Norm statistics are flax's: the mean and ``E[x^2] - mean^2`` clamped at 0,
  eps 1e-5 (torch's default, pinned by the factory). ``BatchNorm`` keeps
  running statistics updated with the biased batch variance at ``momentum``
  0.9, flax's convention (torch's ``momentum=0.1``; torch's own BatchNorm
  would update with the unbiased variance).
* Dropout draws its keep mask from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

LayerCfg = Union[str, Mapping[str, Any]]


def parse_cfg(cfg: LayerCfg) -> Tuple[str, Dict[str, Any]]:
    """``"Name"`` or ``{"type": "Name", **kwargs}`` -> (name, kwargs)."""
    if isinstance(cfg, str):
        return cfg, {}
    if not isinstance(cfg, Mapping):
        raise TypeError(f"illegal layer cfg type: {type(cfg)}")
    kwargs = dict(cfg)
    return kwargs.pop("type"), kwargs


# name -> activation factory; JAX's gelu is the tanh approximation
_ACTIVATIONS: Dict[str, Callable[..., Callable[[torch.Tensor], torch.Tensor]]] = {
    "ReLU": lambda: F.relu,
    # the reference factory's slope is 0.2, not torch's default 0.01
    "LeakyReLU": lambda negative_slope=0.2: (
        lambda x: F.leaky_relu(x, negative_slope=negative_slope)),
    "ELU": lambda: F.elu,
    "GELU": lambda: (lambda x: F.gelu(x, approximate="tanh")),
    "Sigmoid": lambda: torch.sigmoid,
    "Softplus": lambda: F.softplus,
    "Tanh": lambda: torch.tanh,
    "Identity": lambda: (lambda x: x),
}


def build_act_layer(act_cfg: Optional[LayerCfg]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation function; None -> identity."""
    if act_cfg is None:
        return lambda x: x
    name, kwargs = parse_cfg(act_cfg)
    if name not in _ACTIVATIONS:
        raise ValueError(f"illegal activation: {name}")
    return _ACTIVATIONS[name](**kwargs)


class Dropout(nn.Module):
    """Inverted dropout: keeps each entry with probability 1 - p, scaled by
    1 / (1 - p). A no-op for p in (None, 0) and when ``deterministic``."""

    def __init__(self, p: Optional[float]):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or not self.p:
            return x
        if generator is None:
            raise ValueError("dropout: pass a torch.Generator to draw the keep mask")
        keep_prob = 1.0 - self.p
        draw = torch.rand(x.shape, generator=generator, device=generator.device)
        keep = draw.to(x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def build_dropout_layer(p: Optional[float]) -> Dropout:
    """Dropout module; p in (None, 0) -> a no-op."""
    return Dropout(p)


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
               weight: Optional[torch.Tensor], bias: Optional[torch.Tensor]) -> torch.Tensor:
    """flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x - mean) * mul
    return y if bias is None else y + bias


def _stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and flax's fast variance ``E[x^2] - mean^2`` (clamped at 0)."""
    mean = x.mean(dims, keepdim=True)
    var = torch.clamp_min((x * x).mean(dims, keepdim=True) - mean * mean, 0.0)
    return mean, var


class _Norm(nn.Module):
    def __init__(self, num_features: int, epsilon: float, use_scale: bool, use_bias: bool):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None


class GroupNorm(_Norm):
    """Statistics per leading-axis sample and group of consecutive channels,
    over every other axis. ``num_groups = C`` without scale or bias is the
    factory's InstanceNorm."""

    def __init__(self, num_features: int, num_groups: int = 32, epsilon: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True):
        super().__init__(num_features, epsilon, use_scale, use_bias)
        if num_features % num_groups:
            raise ValueError(f"GroupNorm: {num_features} channels in {num_groups} groups")
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xr = x.reshape(b, -1, g, c // g)
        mean, var = _stats(xr, (1, 3))
        expand = lambda t: t.expand(b, 1, g, c // g).reshape(b, 1, c)  # noqa: E731
        y = _normalize(x.reshape(b, -1, c), expand(mean), expand(var), self.epsilon,
                       self.weight, self.bias)
        return y.reshape(x.shape)


class LayerNorm(_Norm):
    """Statistics over the last (channel) axis."""

    def __init__(self, num_features: int, epsilon: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__(num_features, epsilon, use_scale, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _stats(x, -1)
        return _normalize(x, mean, var, self.epsilon, self.weight, self.bias)


class BatchNorm(_Norm):
    """Statistics over every axis but the last. In training (``not
    use_running_average``) it normalises with the batch statistics and moves
    the running ones: ``r = momentum * r + (1 - momentum) * batch``, with the
    biased batch variance, as flax does."""

    def __init__(self, num_features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True):
        super().__init__(num_features, epsilon, use_scale, use_bias)
        self.momentum = momentum
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = _stats(x.reshape(-1, x.shape[-1]), 0)
            mean, var = mean[0], var[0]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        return _normalize(x, mean, var, self.epsilon, self.weight, self.bias)


def build_norm_layer(num_features: int, norm_cfg: Optional[LayerCfg]) -> Optional[nn.Module]:
    """GroupNorm (32 groups by default), LayerNorm, BatchNorm{1,2,3}d or
    InstanceNorm{1,2,3}d (GroupNorm with a group per channel, no scale or
    bias by default); None -> None. The channel axis is last."""
    if norm_cfg is None:
        return None
    name, kwargs = parse_cfg(norm_cfg)
    kwargs.setdefault("epsilon", 1e-5)
    if name == "GroupNorm":
        return GroupNorm(num_features, num_groups=kwargs.pop("num_groups", 32), **kwargs)
    if name == "LayerNorm":
        return LayerNorm(num_features, **kwargs)
    if name.startswith("BatchNorm"):
        kwargs.setdefault("momentum", 0.9)
        return BatchNorm(num_features, **kwargs)
    if name.startswith("InstanceNorm"):
        kwargs.setdefault("use_scale", False)
        kwargs.setdefault("use_bias", False)
        return GroupNorm(num_features, num_groups=num_features, **kwargs)
    raise ValueError(f"illegal normalization: {name}")


def _conv_padding(padding: Union[str, int], sizes: Sequence[int], kernel: Sequence[int],
                  stride: Sequence[int], dilation: Sequence[int]) -> list:
    """(low, high) padding per spatial axis, as ``lax.conv_general_dilated``
    resolves it: ``"SAME"`` pads ``total = max((ceil(n / s) - 1) s + (k - 1) d
    + 1 - n, 0)`` with ``low = total // 2`` (uneven for stride > 1),
    ``"VALID"`` none, an int the same on both sides."""
    if isinstance(padding, str):
        if padding == "VALID":
            return [(0, 0)] * len(sizes)
        if padding != "SAME":
            raise ValueError(f"unsupported conv padding {padding!r}")
        pads = []
        for n, k, s, d in zip(sizes, kernel, stride, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    return [(int(padding), int(padding))] * len(sizes)


class ConvBlock(nn.Module):
    """Conv/Linear -> Norm -> Act (-> Dropout) on channel-last inputs.

    ``conv_cfg`` is ``"Linear"`` or ``"Conv{1,2,3}d"``; ``kernel_size`` is an
    int (the JAX package's) or one size per spatial axis; ``padding`` is
    ``"SAME"``, ``"VALID"`` or an int. The conv bias is
    dropped when a BatchNorm or InstanceNorm follows it, unless
    ``act_before_norm`` puts the activation between them."""

    def __init__(self, in_channels: int, out_channels: int, conv_cfg: LayerCfg = "Linear",
                 kernel_size: Union[int, Sequence[int], None] = None, stride: int = 1,
                 padding: Union[str, int] = 0, dilation: int = 1, groups: int = 1,
                 norm_cfg: Optional[LayerCfg] = None, act_cfg: Optional[LayerCfg] = None,
                 act_before_norm: bool = False, dropout: Optional[float] = None):
        super().__init__()
        conv_name, conv_kwargs = parse_cfg(conv_cfg)
        if conv_kwargs:
            raise ValueError(f"conv cfg keywords are not supported: {sorted(conv_kwargs)}")
        norm_name = parse_cfg(norm_cfg)[0] if norm_cfg is not None else ""
        use_bias = act_before_norm or not norm_name.startswith(("BatchNorm", "InstanceNorm"))
        self.ndim = 0
        if conv_name == "Linear":
            self.Dense_0 = nn.Linear(in_channels, out_channels, bias=use_bias)
        elif conv_name in ("Conv1d", "Conv2d", "Conv3d"):
            if kernel_size is None:
                raise ValueError(f"{conv_name} requires kernel_size")
            self.ndim = int(conv_name[4])
            conv = (nn.Conv1d, nn.Conv2d, nn.Conv3d)[self.ndim - 1]
            self.Conv_0 = conv(in_channels, out_channels, kernel_size, stride=stride, padding=0,
                               dilation=dilation, groups=groups, bias=use_bias)
            self.padding = padding
        else:
            raise ValueError(f"illegal conv layer: {conv_name}")
        norm = build_norm_layer(out_channels, norm_cfg)
        self.norm_name = None if norm is None else f"{type(norm).__name__}_0"
        if norm is not None:
            self.add_module(self.norm_name, norm)
        self.act = build_act_layer(act_cfg)
        self.act_before_norm = act_before_norm
        self.dropout = build_dropout_layer(dropout)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        conv, nd = self.Conv_0, self.ndim
        lead = x.shape[:x.dim() - nd - 1]
        x = x.reshape((-1,) + tuple(x.shape[-nd - 1:])).movedim(-1, 1)
        pads = _conv_padding(self.padding, x.shape[2:], conv.kernel_size, conv.stride,
                            conv.dilation)
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        y = conv(x).movedim(1, -1)
        return y.reshape(tuple(lead) + tuple(y.shape[1:]))

    def _norm(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.norm_name is None:
            return x
        norm = getattr(self, self.norm_name)
        if isinstance(norm, BatchNorm):
            return norm(x, use_running_average=not train)
        return norm(x)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._conv(x) if self.ndim else self.Dense_0(x)
        if self.act_before_norm:
            x = self._norm(self.act(x), train)
        else:
            x = self.act(self._norm(x, train))
        return self.dropout(x, deterministic=not train, generator=generator)
