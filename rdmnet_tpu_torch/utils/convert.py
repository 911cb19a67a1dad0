"""Weights of the JAX package <-> a ``state_dict`` of the port's ``RDMNet``.

The port names its submodules after the flax parameter tree, so conversion
is a tree walk: the path joins with "." and each leaf maps by name —
Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), transposed; Conv
``kernel`` (*spatial, Cin/groups, Cout) -> Conv{1,2,3}d ``weight`` (Cout,
Cin/groups, *spatial); norm ``scale`` -> ``weight``; ``bias``, KPConv
``weights`` and ``kernel_points`` and the dustbin ``alpha`` verbatim; the
``batch_stats`` collection's ``mean``/``var`` -> BatchNorm's
``running_mean``/``running_var``. The result loads with ``strict=True``.

The JAX package's serving artifact stores the tree flat (``weights.npz``,
keys ``w{i}``) in ``jax.tree_util.tree_flatten`` order: dict keys sorted at
every level. ``flat_leaf_paths`` derives that order from the tree itself,
so the port reads and writes the same file.

``train_state_from_jax`` carries a whole JAX ``TrainState`` across: the
weights, the optax chain's Adam moments and counts, its non-finite counter
and the ``MultiSteps`` accumulator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _kernel_perm(rank: int) -> Tuple[int, ...]:
    """Axes of a flax kernel -> the torch weight: (in, out) -> (out, in);
    (*spatial, Cin/groups, Cout) -> (Cout, Cin/groups, *spatial)."""
    return (rank - 1, rank - 2) + tuple(range(rank - 2))


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables -> torch state_dict: a parameter tree (nested dicts of
    arrays), or the collections ``{"params": ...}`` with, optionally,
    ``"batch_stats"``."""
    collections = set(params.keys())
    stats: Mapping = {}
    if "params" in collections and collections <= {"params", "batch_stats"}:
        params, stats = params["params"], params.get("batch_stats", {})
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str, rename) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.", rename)
                continue
            name, arr = rename(name, np.asarray(value, dtype=np.float32))
            # a writable C-order copy that keeps 0-d shapes (the dustbin alpha)
            state[prefix + name] = torch.from_numpy(np.array(arr, order="C"))

    def param(name, arr):
        if name == "kernel":
            return "weight", arr.transpose(_kernel_perm(arr.ndim))
        return ("weight" if name == "scale" else name), arr

    walk(params, "", param)
    walk(stats, "", lambda name, arr: (BATCH_STATS[name], arr))
    return state


def params_to_jax(model: nn.Module) -> dict:
    """Inverse of ``params_from_jax``: the model's state_dict as the flax
    variables ``{"params": {...}}`` of float32 numpy arrays, plus
    ``"batch_stats"`` where the model holds running statistics. A Linear's
    or a convolution's ``weight`` becomes its ``kernel``, any other
    ``weight`` a norm's ``scale``."""
    kernels = {name for name, mod in model.named_modules()
               if isinstance(mod, (nn.Linear, nn.modules.conv._ConvNd))}
    stat_names = {v: k for k, v in BATCH_STATS.items()}
    variables: dict = {}
    for key, value in model.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        arr = value.detach().cpu().numpy()
        collection = "batch_stats" if leaf in stat_names else "params"
        if leaf == "weight" and prefix in kernels:
            leaf, arr = "kernel", arr.transpose(np.argsort(_kernel_perm(arr.ndim)))
        elif leaf == "weight":
            leaf = "scale"
        leaf = stat_names.get(leaf, leaf)
        node = variables.setdefault(collection, {})
        for part in prefix.split(".") if prefix else ():
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr, dtype=np.float32, order="C")  # keeps 0-d shapes
    variables.setdefault("params", {})
    return variables


def flat_leaf_paths(tree: Mapping) -> List[Tuple[str, ...]]:
    """Leaf paths of a nested dict in ``jax.tree_util.tree_flatten`` order
    (keys sorted at every level, depth first)."""
    paths: List[Tuple[str, ...]] = []

    def walk(node: Mapping, prefix: Tuple[str, ...]) -> None:
        for name in sorted(node):
            if isinstance(node[name], Mapping):
                walk(node[name], prefix + (name,))
            else:
                paths.append(prefix + (name,))

    walk(tree, ())
    return paths


def flatten_params(model: nn.Module) -> List[np.ndarray]:
    """The model's weights as the JAX artifact's flat list (``w{i}``)."""
    tree = params_to_jax(model)
    out = []
    for path in flat_leaf_paths(tree):
        node = tree
        for part in path:
            node = node[part]
        out.append(node)
    return out


def load_flat_params(model: nn.Module, flat: Sequence[np.ndarray]) -> None:
    """Load the JAX artifact's flat list into ``model`` (``strict=True``):
    the tree layout comes from the model, the values in flatten order."""
    template = params_to_jax(model)
    paths = flat_leaf_paths(template)
    if len(paths) != len(flat):
        raise ValueError(f"{len(flat)} weight arrays for a model with {len(paths)}")
    tree: dict = {}
    for path, arr in zip(paths, flat):
        node, want = tree, template
        for part in path[:-1]:
            node, want = node.setdefault(part, {}), want[part]
        if tuple(np.shape(arr)) != want[path[-1]].shape:
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(arr)}, the model has "
                             f"{want[path[-1]].shape}")
        node[path[-1]] = arr
    model.load_state_dict(params_from_jax(tree), strict=True)


def _fields(node) -> Optional[dict]:
    """An optax state node's (a NamedTuple's) fields by name, else None."""
    if hasattr(node, "_fields"):
        return {f: getattr(node, f) for f in node._fields}
    return None


def _optax_states(opt_state) -> Dict[str, dict]:
    """The parts of the JAX package's optimizer state by role: ``adam``
    (count, mu, nu), ``schedule`` (count), ``finite`` (apply_if_finite's
    counters) and ``multisteps`` (mini_step, acc_grads), wherever the chain
    nests them."""
    found: Dict[str, dict] = {}

    def walk(node) -> None:
        fields = _fields(node)
        if fields is None:
            if isinstance(node, (list, tuple)):
                for child in node:
                    walk(child)
            return
        keys = set(fields)
        if {"count", "mu", "nu"} <= keys:
            found["adam"] = fields
        elif keys == {"count"}:
            found["schedule"] = fields
        elif "notfinite_count" in keys:
            found["finite"] = fields
        elif {"mini_step", "acc_grads"} <= keys:
            found["multisteps"] = fields
        for name, child in fields.items():
            if name not in ("mu", "nu", "acc_grads"):  # parameter trees
                walk(child)

    walk(opt_state)
    return found


def train_state_from_jax(state_np: Any, model: nn.Module, cfg, steps_per_epoch: int):
    """A JAX ``TrainState`` as host numpy (restored, then
    ``jax.device_get``) -> the port's ``TrainState`` over ``model`` that
    continues it: the weights through ``params_from_jax``; Adam's ``mu``/``nu``
    as ``exp_avg``/``exp_avg_sq`` (Dense kernels transposed as the weights
    are), its count as each parameter's ``step``; the schedule's count as
    ``count``; ``apply_if_finite``'s ``notfinite_count``; under
    ``MultiSteps`` the ``mini_step`` and the accumulator. The moments of
    ``kernel_points`` are dropped: they are buffers in the port."""
    from rdmnet_tpu_torch.engine.train_step import create_train_state

    get = (lambda name: state_np[name]) if isinstance(state_np, Mapping) \
        else (lambda name: getattr(state_np, name))
    model.load_state_dict(params_from_jax(get("params")), strict=True)
    state = create_train_state(cfg, model, steps_per_epoch)
    parts = _optax_states(get("opt_state"))
    missing = {"adam", "schedule", "finite"} - set(parts)
    if missing or ((cfg.optim.grad_acc_steps > 1) != ("multisteps" in parts)):
        raise ValueError(f"the optimizer state does not match cfg.optim (found {sorted(parts)})")
    mu, nu = params_from_jax(parts["adam"]["mu"]), params_from_jax(parts["adam"]["nu"])
    names = state.param_names
    extra = set(mu) - set(names)
    if set(names) - set(mu) or any(not n.endswith("kernel_points") for n in extra):
        raise ValueError(f"the moments cover other parameters than the model's: "
                         f"{sorted((set(names) - set(mu)) | extra)[:5]}")
    step = torch.tensor(float(np.asarray(parts["adam"]["count"])))
    state.optimizer.load_state_dict({
        "state": {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                  for i, n in enumerate(names)},
        "param_groups": state.optimizer.state_dict()["param_groups"],
    })
    state.pin_lr()
    state.count = int(np.asarray(parts["schedule"]["count"]))
    state.notfinite_count = int(np.asarray(parts["finite"]["notfinite_count"]))
    if "multisteps" in parts:
        state.mini_step = int(np.asarray(parts["multisteps"]["mini_step"]))
        if state.mini_step:
            acc = params_from_jax(parts["multisteps"]["acc_grads"])
            for n, a in zip(names, state.accumulator):
                a.copy_(acc[n])
    return state
