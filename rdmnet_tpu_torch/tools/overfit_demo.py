"""Learning-loop demonstrations on the card (twin of ``scripts/overfit_demo.py``
and of ``tests/test_vote_rescue.py::test_vote_rescue_self_contained``).

    python -m rdmnet_tpu_torch.tools.overfit_demo [--steps 600] [--lr 5e-4]
        [--log_every 50] [--coarse_module thdroformer|geotransformer|ape]
        [--device cuda] [--vote_seeds 1-16]

The overfit demo trains ``make_cfg()`` at the 0.7 bucket from random weights
(``init_seed``) on one procedural scan and a copy moved by a known pose
(``demo_pair``), the batch built once, and logs loss, PIR, IR, RR, RRE and
RTE every ``log_every`` steps with ``make_eval_step``. ``main`` then copies
the trained model to the CPU and holds the card's run against the CPU's on
the same host arrays (``card_vs_cpu``, by ``hold_card_to_cpu``, the checks
``chip_smoke.py`` phase 16 makes). Runs on the card unless ``--device
cpu`` is given; without a card it raises.

The vote-rescue recipe (``fov_pair``, ``vote_rescue_cfg``, ``vote_rescue``)
trains the tiny config on an asymmetric 290-degree field-of-view pair and
returns the PIR with the vote layer's node selection on and off.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rdmnet_tpu_torch.config import Config, make_cfg, make_tiny_cfg
from rdmnet_tpu_torch.data.procedural import procedural_pair, procedural_sequence
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.engine import (batch_to_device, create_train_state, make_eval_step,
                                     make_train_step)
from rdmnet_tpu_torch.graph.pyramid import pad_cloud
from rdmnet_tpu_torch.losses import Evaluator
from rdmnet_tpu_torch.losses.evaluator import isotropic_transform_error
from rdmnet_tpu_torch.models import RDMNet
from rdmnet_tpu_torch.ops.geometry import apply_transform
from rdmnet_tpu_torch.ops.kernels import launch_counts
from rdmnet_tpu_torch.ops.lgr import local_to_global_registration
from rdmnet_tpu_torch.ops.procrustes import cross_covariance, horn_matrix, weighted_procrustes

SCAN_SEED = 7351  # the scan: procedural_pair(SCAN_SEED, n_rings=80, n_azimuths=3000)[0]
# a run on the card held to the CPU port's with the same weights (``hold_card_to_cpu``):
NEAR_TIE_RTOL = 1e-4  # a node pair matched on one side only, above that side's lowest score
PLAN_TOL = 1e-3       # log transport plans (max abs)
SCORE_TOL = 1e-6      # LGR correspondence scores (max abs)
RESIDUAL_TOL = 1e-4   # LGR hypotheses' weighted residuals (m)
POSE_TOL = 1e-4       # poses (max abs entry)
LGR_INPUTS = ("ref_node_corr_knn_points", "src_node_corr_knn_points", "ref_node_corr_knn_masks",
              "src_node_corr_knn_masks", "matching_scores", "node_corr_valid")
NODE_KEYS = ("dropped", "nodes_ref_valid", "nodes_src_valid", "ref_node_masks", "src_node_masks")
NODE_CORR = ("ref_node_corr_indices", "src_node_corr_indices", "node_corr_scores",
             "node_corr_valid")

def demo_cfg(lr: float = 5e-4, coarse_module: Optional[str] = None) -> Config:
    """``make_cfg()`` at the 0.7 bucket, ``lr``, no gradient accumulation."""
    cfg = make_cfg()
    cfg = dataclasses.replace(
        cfg, pyramid=cfg.pyramid.scaled(0.7),
        optim=dataclasses.replace(cfg.optim, lr=lr, grad_acc_steps=1))
    if coarse_module is not None:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, coarse_module=coarse_module))
    return cfg


def demo_scan() -> np.ndarray:
    return procedural_pair(SCAN_SEED, n_rings=80, n_azimuths=3000)[0]


def demo_pair(ref: np.ndarray):
    """(ref, src, tf_gt): ``src`` is ``ref`` moved by 104 degrees about (0.2,
    -0.1, 1) and t = (3, -2, 0.5), plus 0.02 m of noise from
    ``RandomState(0)``; ``tf_gt`` maps src onto ref."""
    ref = np.asarray(ref)[:, :3].astype(np.float32)
    rng = np.random.RandomState(0)
    angle = np.deg2rad(104.0)
    axis = np.array([0.2, -0.1, 1.0])
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r = (np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)).astype(np.float32)
    t = np.array([3.0, -2.0, 0.5], np.float32)
    tf_gt = np.eye(4, dtype=np.float32)
    tf_gt[:3, :3] = r
    tf_gt[:3, 3] = t
    src = ((ref - t) @ r).astype(np.float32) + rng.randn(*ref.shape).astype(np.float32) * 0.02
    return ref, src, tf_gt


def host_batch(ref, src, tf_gt, cap: int) -> Dict[str, np.ndarray]:
    """One pair padded to ``cap`` rows, as ``batch_to_device`` takes it."""
    (rp, rc), (sp, sc) = pad_cloud(ref, cap), pad_cloud(src, cap)
    return {"ref_points": rp.numpy()[None], "ref_counts": rc.numpy()[None],
            "src_points": sp.numpy()[None], "src_counts": sc.numpy()[None],
            "transform": np.asarray(tf_gt, np.float32)[None]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launch_counts().items()}


@dataclasses.dataclass
class Demo:
    """What ``run`` returns: the printed ``rows`` (and ``final``), the loss of
    every step, the kernel launches of the build, of all train steps and of
    all eval steps (0 on the CPU), and the trained state with its batch."""

    rows: List[Dict[str, float]]
    final: Dict[str, float]
    losses: List[float]
    launches: Dict[str, Dict[str, int]]
    n_evals: int
    state: object
    batch: list
    host: Dict[str, np.ndarray]


def row_text(row: Dict[str, float]) -> str:
    """The JAX script's log line."""
    return (f"step {row['step']:4d} | loss {row['loss']:.4f} c {row['c_loss']:.3f} "
            f"g {row['g_loss']:.3f} | PIR {row['PIR']:.3f} IR {row['IR']:.3f} "
            f"RR {row['RR']:.0f} RRE {row['RRE']:.2f}deg RTE {row['RTE']:.3f}m "
            f"| {row['ms_per_step']:.0f} ms/step")


def final_text(final: Dict[str, float]) -> str:
    return (f"FINAL: RR {final['RR']:.0f} RRE {final['RRE']:.3f} deg "
            f"RTE {final['RTE']:.4f} m IR {final['IR']:.3f}")


def run(cfg: Config, ref, src, tf_gt, steps: int = 600, log_every: int = 50, device=None,
        init_seed: int = 0, draw_seed: int = 1, params: Optional[dict] = None,
        verbose: bool = True) -> Demo:
    """Train ``cfg`` on the one pair (ref, src, tf_gt) for ``steps`` steps and
    evaluate at step 1, every ``log_every`` steps and after the last. The
    batch is built once. The weights are ``RDMNet``'s seeded init
    (``init_seed``) unless ``params`` (a state dict) replaces them; the
    target draws come from a generator on the device seeded ``draw_seed``.
    A row's ``ms_per_step`` is the mean wall time of the train steps so far,
    the evaluations left out."""
    dev = resolve_device(device)
    host = host_batch(ref, src, tf_gt, cfg.pyramid.caps[0])
    before = launch_counts()
    batch = batch_to_device(host, cfg.pyramid, device=dev)
    _sync(dev)
    launches = {"build": _delta(before)}
    model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(init_seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, device=dev)
    eval_step = make_eval_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    gt = torch.as_tensor(tf_gt, dtype=torch.float32, device=dev)
    eval_counts = dict.fromkeys(launch_counts(), 0)
    n_evals = 0

    def evaluate():
        nonlocal n_evals
        mark = launch_counts()
        ev, tfs = eval_step(state, batch)
        rre, rte = isotropic_transform_error(gt, tfs[0])
        for name, n in _delta(mark).items():
            eval_counts[name] += n
        n_evals += 1
        return {"PIR": float(ev["PIR"]), "IR": float(ev["IR"]), "RR": float(ev["RR"]),
                "RRE": float(rre), "RTE": float(rte)}

    rows, losses = [], []
    train_counts = dict.fromkeys(launch_counts(), 0)
    train_s = 0.0
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        mark = launch_counts()
        state, metrics = step(state, batch, gen)
        for name, n in _delta(mark).items():
            train_counts[name] += n
        losses.append(metrics["loss"].detach())
        if i % log_every == 0 or i == 1:
            _sync(dev)
            train_s += time.perf_counter() - t0
            row = {"step": i, **{k: float(metrics[k]) for k in ("loss", "c_loss", "g_loss")},
                   **evaluate(), "ms_per_step": train_s / i * 1e3}
            rows.append(row)
            if verbose:
                print(row_text(row), flush=True)
            _sync(dev)
            t0 = time.perf_counter()
    final = evaluate()
    if verbose:
        print(final_text(final), flush=True)
    launches.update(train=train_counts, eval=eval_counts)
    return Demo(rows=rows, final=final, losses=[float(x) for x in losses], launches=launches,
                n_evals=n_evals, state=state, batch=batch, host=host)


def _plan_error(a, b) -> Optional[float]:
    """Max abs difference of two runs' log transport plans (a on any device,
    b on the CPU); None when their masks differ."""
    a = a.cpu()
    live = b > -1e11
    if not torch.equal(a > -1e11, live):
        return None
    return float((a - b)[live].abs().max()) if bool(live.any()) else 0.0


def near_tie_plan_error(a, b):
    """Two runs' (a: card, b: CPU) matched node pairs: (max abs difference of
    their log transport plans through the pairs both matched, the number of
    those, the number matched on one side only, the largest relative height
    of such a pair's score above its side's lowest matched score). None for
    the error when the runs have no pair in common or the common pairs'
    patches mask other rows."""
    m = b["src_node_masks"].shape[0]
    runs = []
    for o in (a, b):
        valid = o["node_corr_valid"].cpu()
        keys = (o["ref_node_corr_indices"].long().cpu() * m
                + o["src_node_corr_indices"].long().cpu()).tolist()
        runs.append(({k: i for i, k in enumerate(keys) if valid[i]},
                     o["node_corr_scores"].cpu(), valid))
    common = sorted(runs[0][0].keys() & runs[1][0].keys())
    gap, parted = 0.0, 0
    for (mine, scores, valid), (other, _, _) in (runs, runs[::-1]):
        floor = float(scores[valid].min())
        for k, i in mine.items():
            if k not in other:
                parted += 1
                gap = max(gap, (float(scores[i]) - floor) / floor)
    if not common:
        return None, 0, parted, gap
    err = _plan_error(a["matching_scores"][[runs[0][0][k] for k in common]],
                      b["matching_scores"][[runs[1][0][k] for k in common]])
    return err, len(common), parted, gap


def hypothesis_residuals(corr):
    """Per-patch Procrustes hypotheses of an LGR correspondence set, as LGR
    forms them: each hypothesis's weighted mean residual on its own patch
    (m) and the patch's number of correspondences."""
    p = int(corr.patch_ids.max()) + 1
    src, ref = corr.src_points.reshape(p, -1, 3), corr.ref_points.reshape(p, -1, 3)
    w = corr.scores.reshape(p, -1)
    hyp = weighted_procrustes(src, ref, w)
    res = torch.linalg.norm(ref - apply_transform(src, hyp), dim=-1)
    return (res * w).sum(-1) / (w.sum(-1) + 1e-12), (w > 0).sum(-1)


def lgr_parting(ta: dict, tb: dict, radius: float):
    """Where two LGR runs on the same inputs (traces ``ta`` from any device,
    ``tb`` from the CPU) first decide otherwise: (decision, margin, index), or
    None when every decision is the same. The margin is the largest distance
    from its threshold of an entry decided otherwise: a score's from the
    lowest score the correspondence limit keeps, a residual's from the
    acceptance radius (m); only hypotheses that may be chosen count. The
    index is the hypothesis that holds the largest such entry, or the
    refinement step."""
    n = tb["ver_scores"].shape[0]
    ia = ta["ver_index"].cpu() if ta["ver_index"] is not None else torch.arange(n)
    ib = tb["ver_index"] if tb["ver_index"] is not None else torch.arange(n)
    moved = sorted(set(ia.tolist()) ^ set(ib.tolist()))
    if moved:
        kth = tb["ver_scores"][ib[-1]]
        return "correspondence limit", float((tb["ver_scores"][moved] - kth).abs().max()), None
    where = {int(i): j for j, i in enumerate(ia.tolist())}
    perm = torch.tensor([where[int(i)] for i in ib.tolist()], dtype=torch.long)
    keep = tb["ver_scores"][ib] > 0
    for step, (ra, rb) in enumerate(zip(ta["residuals"], tb["residuals"])):
        ra = ra.cpu()[:, perm]
        flipped = ((ra < radius) != (rb < radius)) & keep
        if step == 0:
            flipped &= tb["gate"][:, None]
        if bool(flipped.any()):
            dist = torch.where(flipped, torch.maximum((ra - radius).abs(), (rb - radius).abs()),
                               torch.zeros_like(rb))
            row = int(dist.max(dim=1).values.argmax())
            if step == 0:
                return "inliers of the hypotheses", float(dist.max()), row
            return f"inliers of refinement {step}", float(dist.max()), step
        if step == 0 and int(ta["best"]) != int(tb["best"]):
            return "best hypothesis", float("inf"), int(tb["best"])
    return None


def horn_gap(src, ref, weights) -> float:
    """The relative gap (l4 - l3) / (l4 - l1) between the two largest
    eigenvalues l4, l3 of Horn's matrix of a weighted fit (l1 the smallest):
    a perturbation E of that matrix turns the fit's rotation by about
    |E| / (l4 - l3), so a small gap is an ill-conditioned fit."""
    lam = torch.linalg.eigvalsh(horn_matrix(cross_covariance(src, ref, weights)[0]).double())
    return float((lam[-1] - lam[-2]) / (lam[-1] - lam[0]).clamp_min(1e-300))


def _lgr_gap_text(corr, trace: dict, parting) -> str:
    """The LGR pose's first parting and the fit at it (the parting
    hypothesis, the fit before the parting refinement, or the last fit):
    its eigen-gap and its number of weighted correspondences."""
    if parting is not None and parting[2] is None:
        return f"first parting at {parting[0]}, an entry {parting[1]:.3e} from its threshold"
    p = int(corr.patch_ids.max()) + 1
    ver = trace["ver_index"] if trace["ver_index"] is not None else \
        torch.arange(corr.scores.shape[0])
    fit = (corr.src_points[ver], corr.ref_points[ver])
    if parting is None:
        where, w = "the runs take the same decisions; the last fit", trace["weights"][-1]
    elif parting[0] != "inliers of the hypotheses":
        where, w = "the fit before it", trace["weights"][parting[2] - 1]
    elif parting[2] == p:
        where, w = "the global fit", corr.scores[ver]
    else:
        where, w = f"patch {parting[2]}'s fit", corr.scores.reshape(p, -1)[parting[2]]
        fit = (corr.src_points.reshape(p, -1, 3)[parting[2]],
               corr.ref_points.reshape(p, -1, 3)[parting[2]])
    if parting is not None:
        where = f"first parting at {parting[0]}, an entry {parting[1]:.3e} m from the radius; {where}"
    return (f"{where}: eigen-gap {horn_gap(*fit, w):.3e} (relative) on {int((w > 0).sum())} "
            "weighted correspondences")


@dataclasses.dataclass
class Check:
    """One comparison of ``hold_card_to_cpu``: ``status`` is ``ok``,
    ``FAILED`` or ``not held: <why>``."""

    name: str
    status: str
    detail: str

    def text(self) -> str:
        return f"{self.name}: {self.status} ({self.detail})"


def _held(name: str, value: Optional[float], limit: float, detail: str = "") -> Check:
    ok = value is not None and value <= limit
    shown = "none" if value is None else f"{value:.3e}"
    return Check(name, "ok" if ok else "FAILED", f"{shown}, limit {limit}{detail}")


@torch.no_grad()
def hold_card_to_cpu(cfg: Config, model, b_card, b_cpu, o_card, o_cpu, gt) -> Dict:
    """``model``'s inference on the card (outputs ``o_card`` on ``b_card``)
    held to the CPU port's with the same weights on its own build of the
    same inputs (``o_cpu`` on ``b_cpu``); ``gt`` is the pair's true pose.

    - tables: every level's points and index tables equal;
    - node masks: ``NODE_KEYS`` equal;
    - near-ties: the matched node pairs equal but for near-ties at the top-k
      boundary (a pair matched on one side only scores within
      ``NEAR_TIE_RTOL``, relative, of that side's lowest matched score);
    - plans: log transport plans through the pairs both matched within
      ``PLAN_TOL`` (not held when the runs matched no pair in common);
    - LGR on the CPU's plans on both devices: equal correspondence sets,
      scores within ``SCORE_TOL``, hypotheses' residuals within
      ``RESIDUAL_TOL``; the pose within ``POSE_TOL`` when the CPU's pose
      registers the pair (the evaluator's RR), otherwise reported with where
      the two runs first decide otherwise (``lgr_parting``) and the
      eigen-gap of the fit there (``horn_gap``);
    - replay: the card's model on the CPU's node pairs, plans through every
      pair within ``PLAN_TOL`` and, when the CPU registers, the pose within
      ``POSE_TOL``;
    - whole-path pose within ``POSE_TOL`` when the CPU registers and no node
      pair parted (where pairs parted at near-ties the replay holds it).

    Returns ``checks`` (a list of ``Check``) with what they measured."""
    dev = b_card.transform.device
    tables = sum(not torch.equal(x.cpu(), y)
                 for side in ("ref", "src")
                 for field in ("points", "neighbors", "subsampling", "upsampling")
                 for x, y in zip(getattr(getattr(b_card, side), field),
                                 getattr(getattr(b_cpu, side), field)))
    masks = [k for k in NODE_KEYS
             if k in o_cpu and not torch.equal(o_card[k].cpu(), o_cpu[k])]
    checks = [Check("tables", "ok" if tables == 0 else "FAILED", f"{tables} differ"),
              Check("node masks", "FAILED" if masks else "ok",
                    f"{', '.join(masks) or 'none'} differ")]
    plan_err, common, parted, gap = near_tie_plan_error(o_card, o_cpu)
    checks.append(_held("near-ties", gap, NEAR_TIE_RTOL,
                        f"; {parted} node pairs matched on one side only, {common} on both"))
    if common:
        checks.append(_held("plans", plan_err, PLAN_TOL, f"; through {common} common node pairs"))
    else:
        checks.append(Check("plans", "not held: no node pair in common", f"{parted} parted"))

    gt = torch.as_tensor(np.asarray(gt), dtype=torch.float32)
    rre, rte = isotropic_transform_error(gt, o_cpu["estimated_transform"])
    registered = bool(rre < cfg.eval.rre_threshold and rte < cfg.eval.rte_threshold)
    no_reg = "not held: the CPU's pose does not register"
    lgr_in = [o_cpu[key] for key in LGR_INPUTS] + [o_cpu["node_corr_scores"]]
    tr_c, tr_g = {}, {}
    corr_c, tf_c = local_to_global_registration(*lgr_in[:-1], cfg.fine_matching,
                                                node_corr_scores=lgr_in[-1], trace=tr_c)
    corr_g, tf_g = local_to_global_registration(*[x.to(dev) for x in lgr_in[:-1]],
                                                cfg.fine_matching,
                                                node_corr_scores=lgr_in[-1].to(dev), trace=tr_g)
    same = (torch.equal(corr_g.ref_points.cpu(), corr_c.ref_points)
            and torch.equal(corr_g.src_points.cpu(), corr_c.src_points))
    checks.append(Check("LGR sets", "ok" if same else "FAILED",
                        f"{corr_c.scores.shape[0]} correspondences, "
                        f"{'equal' if same else 'differ'}"))
    checks.append(_held("LGR scores", float((corr_g.scores.cpu() - corr_c.scores).abs().max()),
                        SCORE_TOL))
    (res_g, _), (res_c, n_c) = hypothesis_residuals(corr_g), hypothesis_residuals(corr_c)
    posed = n_c >= cfg.fine_matching.correspondence_threshold
    hyp_err = float((res_g.cpu() - res_c)[posed].abs().max()) if bool(posed.any()) else 0.0
    checks.append(_held("LGR residuals", hyp_err, RESIDUAL_TOL, f"; {int(posed.sum())} hypotheses"))
    lgr_err = float((tf_g.cpu() - tf_c).abs().max())
    if registered or lgr_err <= POSE_TOL:
        checks.append(_held("LGR pose", lgr_err, POSE_TOL))
    else:
        checks.append(Check("LGR pose", no_reg, f"{lgr_err:.3e}; " + _lgr_gap_text(
            corr_c, tr_c, lgr_parting(tr_g, tr_c, cfg.fine_matching.acceptance_radius))))

    replay = model(b_card, training=False, node_corr=tuple(o_cpu[k].to(dev) for k in NODE_CORR))
    checks.append(_held("replay plans", _plan_error(replay["matching_scores"],
                                                    o_cpu["matching_scores"]), PLAN_TOL,
                        "; the card's model on the CPU's node pairs"))
    rep_err = float((replay["estimated_transform"].cpu() - o_cpu["estimated_transform"])
                    .abs().max())
    checks.append(_held("replay pose", rep_err, POSE_TOL) if registered or rep_err <= POSE_TOL
                  else Check("replay pose", no_reg, f"{rep_err:.3e}"))
    pose_err = float((o_card["estimated_transform"].cpu() - o_cpu["estimated_transform"])
                     .abs().max())
    if pose_err <= POSE_TOL:
        checks.append(_held("whole-path pose", pose_err, POSE_TOL))
    elif not registered:
        checks.append(Check("whole-path pose", no_reg, f"{pose_err:.3e}"))
    elif parted:
        checks.append(Check("whole-path pose", f"not held: {parted} node pairs parted at "
                            "near-ties (the replay pose holds it)", f"{pose_err:.3e}"))
    else:
        checks.append(_held("whole-path pose", pose_err, POSE_TOL))
    feats = {k: float((o_card[k].cpu() - o_cpu[k]).abs().max())
             for k in ("ref_feats_c", "src_feats_c", "ref_feats_f", "src_feats_f")}
    return dict(checks=checks, registered=registered, common=common, parted=parted,
                cpu_rre=float(rre), cpu_rte=float(rte), feats=feats)


def report_text(report: Dict) -> str:
    """The checks of ``hold_card_to_cpu``, one a line."""
    feats = ", ".join(f"{k} {v:.3e}" for k, v in report["feats"].items())
    return "\n".join([f"  {c.text()}" for c in report["checks"]]
                     + [f"  features, max abs difference: {feats}"])


@torch.no_grad()
def card_vs_cpu(cfg: Config, demo: Demo, tf_gt) -> Dict:
    """The trained model on the card and a copy on the CPU, each on its own
    build of ``demo.host``, held to each other by ``hold_card_to_cpu``; also
    each device's RR, RRE and RTE and the CPU forward's time. ``ok`` when no
    check failed."""
    model = demo.state.model
    cpu_model = RDMNet(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    b_card = demo.batch[0]
    b_cpu = batch_to_device(demo.host, cfg.pyramid, device="cpu")[0]
    o_card = model(b_card, training=False, with_gt=True)
    t0 = time.perf_counter()
    o_cpu = cpu_model(b_cpu, training=False, with_gt=True)
    cpu_s = time.perf_counter() - t0
    evaluator = Evaluator(cfg)
    ev = {name: {k: float(v) for k, v in evaluator(o, b).items()}
          for name, o, b in (("card", o_card, b_card), ("cpu", o_cpu, b_cpu))}
    report = hold_card_to_cpu(cfg, model, b_card, b_cpu, o_card, o_cpu, tf_gt)
    ok = all(c.status != "FAILED" for c in report["checks"])
    return dict(report, ok=ok, card=ev["card"], cpu=ev["cpu"], cpu_s=cpu_s)


def card_vs_cpu_text(c: Dict) -> str:
    return (f"card vs CPU on the trained state: card RR {c['card']['RR']:.0f} RRE "
            f"{c['card']['RRE']:.4f} deg RTE {c['card']['RTE']:.5f} m, CPU RR {c['cpu']['RR']:.0f} "
            f"RRE {c['cpu']['RRE']:.4f} deg RTE {c['cpu']['RTE']:.5f} m; CPU forward "
            f"{c['cpu_s']:.3f} s: {'ok' if c['ok'] else 'FAILED'}\n" + report_text(c))


# ---- the vote-rescue recipe -------------------------------------------------

def fov_pair():
    """(ref, src, tf_gt): two frames of the seed-31337 procedural sequence,
    a body-fixed 290-degree field of view, 10 rings x 160 azimuths, 6 m apart."""
    scans, poses = procedural_sequence(seed=31337, n_frames=2, n_rings=10, n_azimuths=160,
                                       step=6.0, fov_deg=290.0)
    tf_gt = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    return scans[0][:, :3], scans[1][:, :3], tf_gt


def vote_rescue_cfg(ref, src) -> Config:
    """``make_tiny_cfg()`` with capacities sized to the pair."""
    cfg = make_tiny_cfg()
    caps0 = -(-max(len(ref), len(src)) // 128) * 128
    spec = dataclasses.replace(cfg.pyramid, caps=(caps0, caps0 // 2, caps0 // 4,
                                                  max(caps0 // 8, 32), max(caps0 // 16, 16)))
    return dataclasses.replace(cfg, pyramid=spec)


@torch.no_grad()
def vote_pirs(cfg: Config, model, batch) -> Dict[str, float]:
    """PIR of the trained ``model`` with the vote layer's node selection on
    and off, each arm a model rebuilt from its own config."""
    off = dataclasses.replace(cfg, vote=dataclasses.replace(cfg.vote, inference_use_vote=False))
    pirs = {}
    for name, c in (("on", cfg), ("off", off)):
        m = RDMNet(c, device=model.device)
        m.load_state_dict(model.state_dict(), strict=True)
        out = m(batch, training=False, with_gt=True)
        pirs[name] = float(Evaluator(c)(out, batch, evaling=True)["PIR"])
    return pirs


def vote_rescue(cfg: Config, ref, src, tf_gt, steps: int = 75, device=None, init_seed: int = 0,
                draw_seed: int = 1, params: Optional[dict] = None) -> Dict[str, float]:
    """Train ``cfg`` on (ref, src, tf_gt) for ``steps`` steps (the schedule of
    10 steps an epoch) and return the vote-on and vote-off PIR."""
    dev = resolve_device(device)
    batch = batch_to_device(host_batch(ref, src, tf_gt, cfg.pyramid.caps[0]), cfg.pyramid,
                            device=dev)
    model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(init_seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    state = create_train_state(cfg, model, steps_per_epoch=10)
    step = make_train_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    for _ in range(steps):
        state, _ = step(state, batch, gen)
    return vote_pirs(cfg, state.model, batch[0])


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else \
        torch.cuda.get_device_name(dev)


def main(argv=None) -> Optional[Demo]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--coarse_module", default=None,
                        choices=["thdroformer", "geotransformer", "ape"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--vote_seeds", default=None,
                        help="in place of the demo, the vote-rescue recipe from the seeded init "
                             "for these target-draw seeds, e.g. 1-16")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.vote_seeds is not None:
        lo, _, hi = args.vote_seeds.partition("-")
        ref, src, tf_gt = fov_pair()
        cfg = vote_rescue_cfg(ref, src)
        print(f"vote rescue on {card_name(dev)}: 75 steps from the init seeded 0", flush=True)
        for seed in range(int(lo), int(hi or lo) + 1):
            pirs = vote_rescue(cfg, ref, src, tf_gt, device=dev, draw_seed=seed)
            print(f"draws seeded {seed}: vote-on PIR {pirs['on']:.5f}, vote-off PIR "
                  f"{pirs['off']:.5f}", flush=True)
        return None
    cfg = demo_cfg(args.lr, args.coarse_module)
    ref, src, tf_gt = demo_pair(demo_scan())
    print(f"overfit demo: {cfg.model.coarse_module}, {len(ref)} points a cloud, caps "
          f"{cfg.pyramid.caps}, lr {args.lr}, {args.steps} steps on {card_name(dev)}", flush=True)
    demo = run(cfg, ref, src, tf_gt, args.steps, args.log_every, dev)
    print(f"launches: build {demo.launches['build']}, {args.steps} train steps "
          f"{demo.launches['train']}, {demo.n_evals} eval steps {demo.launches['eval']}")
    if dev.type == "cuda":
        check = card_vs_cpu(cfg, demo, tf_gt)
        print(card_vs_cpu_text(check), flush=True)
        if not check["ok"]:
            raise SystemExit("overfit demo: the card's trained state is off the CPU's")
    return demo


if __name__ == "__main__":
    main()
