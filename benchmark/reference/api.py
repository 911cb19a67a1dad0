"""The reference's entry points, as the benchmark calls them: the served
pipeline of one pair, the pyramid of one pair, and the first training steps.
Plain float32 PyTorch; the caller sets the product precision
(``device.set_precision``) and hands in the inputs and the weights it drew."""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from benchmark.reference.config import Config, config_from_dict
from benchmark.reference.graph.pyramid import build_pair_batch
from benchmark.reference.losses import OverallLoss
from benchmark.reference.models.rdmnet import RDMNet

SERVE_OUTPUTS = ("estimated_transform", "ref_corr_points", "src_corr_points", "corr_scores")
PAD_COORD = 1.0e9


def make_config(values: dict, bucket_scale: float = 1.0) -> Config:
    cfg = config_from_dict(Config, values)
    if bucket_scale != 1.0:
        cfg = dataclasses.replace(cfg, pyramid=cfg.pyramid.scaled(bucket_scale))
    return cfg


def make_model(cfg: Config, weights: Mapping[str, torch.Tensor], device) -> RDMNet:
    model = RDMNet(cfg, device=device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("reference: the weights do not name the model's parameters")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return model


def pad(points: np.ndarray, cap: int):
    """(cap, 3) float32 of the first ``cap`` points, padded; the valid count."""
    n = min(len(points), cap)
    out = np.full((cap, 3), PAD_COORD, np.float32)
    out[:n] = np.asarray(points, np.float32)[:n, :3]
    return out, n


def _batch(cfg: Config, ref, src, transform, device, ref_dropped=0, src_dropped=0):
    cap = cfg.pyramid.caps[0]
    (rp, rc), (sp, sc) = pad(ref, cap), pad(src, cap)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return build_pair_batch(t(rp), t(np.int32(rc)), t(sp), t(np.int32(sc)),
                            t(np.asarray(transform, np.float32)), cfg.pyramid,
                            ref_dropped0=ref_dropped, src_dropped0=src_dropped)


@torch.no_grad()
def serve_pair(model: RDMNet, ref: np.ndarray, src: np.ndarray) -> Dict[str, np.ndarray]:
    """The served outputs of one raw pair (padded or truncated to the
    model's level-0 capacity)."""
    batch = _batch(model.cfg, ref, src, np.eye(4, dtype=np.float32), model.device)
    out = model(batch)
    return {k: out[k].cpu().numpy() for k in SERVE_OUTPUTS}


@torch.no_grad()
def register_served(cfg: Config, answer: Mapping[str, np.ndarray], device):
    """LGR and Procrustes of the reference over a served answer's own flat
    correspondence set: (the pose, the weights of its last fit), as numpy.
    Each patch's correspondences are its rows with a score above 0."""
    from benchmark.reference.ops.lgr import Correspondences, register

    scores = torch.as_tensor(answer["corr_scores"], device=device)
    p = cfg.coarse_matching.num_correspondences
    if scores.shape[0] % p:
        raise ValueError(f"reference: {scores.shape[0]} correspondence rows for {p} patches")
    corr = Correspondences(
        torch.as_tensor(answer["ref_corr_points"], device=device),
        torch.as_tensor(answer["src_corr_points"], device=device), scores,
        torch.arange(p, dtype=torch.int32, device=device).repeat_interleave(scores.shape[0] // p))
    trace = {}
    transform = register(corr, (scores.reshape(p, -1) > 0).sum(dim=1), p, cfg.fine_matching,
                         trace)
    weights = torch.zeros_like(scores)
    if trace["ver_index"] is None:
        weights = trace["weights"][-1]
    else:
        weights[trace["ver_index"]] = trace["weights"][-1]
    return transform.cpu().numpy(), weights.cpu().numpy()


@torch.no_grad()
def pyramid(cfg: Config, ref: np.ndarray, src: np.ndarray, device):
    """(points, counts) per level, each stacked (ref, src): the graph
    build's voxel levels, for the benchmark's counts."""
    batch = _batch(cfg, ref, src, np.eye(4, dtype=np.float32), device)
    pts = [torch.stack([batch.ref.points[i], batch.src.points[i]])
           for i in range(cfg.pyramid.num_stages)]
    cnts = [torch.stack([batch.ref.counts[i], batch.src.counts[i]])
            for i in range(cfg.pyramid.num_stages)]
    return pts, cnts


def _pair(cfg: Config, np_batch: Mapping[str, np.ndarray], b: int, device):
    return _batch(cfg, np_batch["ref_points"][b][:int(np_batch["ref_counts"][b])],
                  np_batch["src_points"][b][:int(np_batch["src_counts"][b])],
                  np_batch["transform"][b], device, ref_dropped=int(np_batch["ref_dropped"][b]),
                  src_dropped=int(np_batch["src_dropped"][b]))


def _batch_loss(model: RDMNet, loss_module, np_batch: Mapping[str, np.ndarray], generators,
                params=None):
    """(the mean over the batch's pairs of the seven loss terms' weighted sum,
    and with ``params`` its gradients): pair b draws its targets from
    ``generators[b]``, or all pairs from one generator in turn."""
    n = len(np_batch["ref_points"])
    grads = None if params is None else [torch.zeros_like(p) for p in params]
    total = 0.0
    for b in range(n):
        pair = _pair(model.cfg, np_batch, b, model.device)
        gen = generators[b] if isinstance(generators, (list, tuple)) else generators
        with torch.enable_grad():
            out = model(pair, training=True, with_gt=True, generator=gen)
            loss = loss_module(out, pair)["loss"]
            if params is not None:
                g = torch.autograd.grad(loss / n, params, allow_unused=True)
                grads = [a + (torch.zeros_like(p) if x is None else x)
                         for a, x, p in zip(grads, g, params)]
        total += float(loss.detach()) / n
    return total, grads


def train_steps(model: RDMNet, batches: Sequence[Mapping[str, np.ndarray]], generators,
                steps_per_epoch: int) -> Dict[str, object]:
    """The first ``len(batches)`` training steps from the model's weights:
    per step the loss (``_batch_loss``), the gradient with the coupled L2
    decay (Adam's input), and plain Adam at the config's lr schedule (the
    base lr times ``parallel.dp`` when ``scale_lr_by_dp``); a step with a
    non-finite gradient is skipped.
    Returns ``losses`` (one a step), ``grads`` (step 1, by parameter),
    ``after`` (the parameters after each step, by parameter, on the host),
    ``change_first`` and ``change`` (their change after the first step and
    after the last)."""
    cfg = model.cfg
    o = cfg.optim
    loss_module = OverallLoss(cfg)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    every = o.lr_decay_steps * max(1, steps_per_epoch // max(1, o.grad_acc_steps))
    if o.scheduler != "step" or o.grad_acc_steps != 1:
        raise ValueError("reference: only the 'step' schedule without accumulation")
    losses, first_grads, after, count = [], None, [], 0
    for np_batch in batches:
        total, grads = _batch_loss(model, loss_module, np_batch, generators, params)
        losses.append(total)
        grads = [g + o.weight_decay * p.detach() for g, p in zip(grads, params)]
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in zip(names, grads)}
        if all(bool(torch.isfinite(g).all()) for g in grads):
            lr = o.lr * (cfg.parallel.dp if cfg.parallel.scale_lr_by_dp else 1) \
                * o.lr_decay ** (count // every)
            count += 1
            with torch.no_grad():
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = mi / (1 - b1 ** count)
                    vhat = vi / (1 - b2 ** count)
                    p.sub_(lr * mhat / (vhat.sqrt() + eps))
        after.append({k: p.detach().to("cpu", copy=True) for k, p in zip(names, params)})
    start = {k: s.cpu() for k, s in zip(names, start)}
    return {"losses": losses, "grads": first_grads, "after": after,
            "change_first": {k: after[0][k] - start[k] for k in names},
            "change": {k: after[-1][k] - start[k] for k in names}}


def step_losses(model: RDMNet, batches: Sequence[Mapping[str, np.ndarray]], generators,
                states: Sequence[Mapping[str, torch.Tensor]]) -> list:
    """Each step's loss (``_batch_loss``) at the parameters ``states`` gives
    for it, the draws taken in the steps' order: a step's loss judged from
    the state that step started from."""
    loss_module = OverallLoss(model.cfg)
    params = dict(model.named_parameters())
    losses = []
    for np_batch, state in zip(batches, states):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state[k])
        losses.append(_batch_loss(model, loss_module, np_batch, generators)[0])
    return losses


def pair_gradient(model: RDMNet, np_batch: Mapping[str, np.ndarray], generator) -> None:
    """One pair's training forward, losses and backward (the first of
    ``np_batch``), for counting its products; the parameters are left as
    they are."""
    cfg = model.cfg
    pair = _pair(cfg, np_batch, 0, model.device)
    params = [p for _, p in model.named_parameters()]
    with torch.enable_grad():
        out = model(pair, training=True, with_gt=True, generator=generator)
        torch.autograd.grad(OverallLoss(cfg)(out, pair)["loss"], params, allow_unused=True)
