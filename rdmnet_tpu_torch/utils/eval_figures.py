"""Trajectory / recall-curve evaluation figures, numpy + headless matplotlib
(own copy of ``rdmnet_tpu/utils/eval_figures.py``).

Re-design of the reference's offline visualization family
(reference: experiments/eval_pose_visualization_offline.py:83-224 — Umeyama
alignment + absolute trajectory error; experiments/
eval_visualization_for_basline_methods.py — recall-vs-threshold curves).
The open3d interactive renderers are replaced by matplotlib files; the
baseline-comparison plots accept any {name: data} dict so external methods'
results can be overlaid.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def umeyama_alignment(
    x: np.ndarray, y: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares Sim(3)/SE(3) alignment y ≈ c·R·x + t (Umeyama 1991;
    reference eval_pose_visualization_offline.py:83-135).

    Args:
      x, y: (3, N) point matrices.
    Returns (R, t, c).
    """
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = float(np.sum((x - mean_x[:, None]) ** 2)) / n
    cov_xy = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, vt = np.linalg.svd(cov_xy)
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(vt) < 0.0:
        s[m - 1, m - 1] = -1.0
    r = u @ s @ vt
    c = float(np.trace(np.diag(d) @ s) / sigma_x) if with_scale else 1.0
    t = mean_y - c * (r @ mean_x)
    return r, t, c


def compose_trajectory(rel_poses: Sequence[np.ndarray]) -> np.ndarray:
    """Chain scan-to-scan relative poses into an absolute trajectory.

    Pair convention (data/datasets.py GT schema + data/preprocess.py
    writing "anc=curr pos=nxt"): src = frame k (EARLIER), ref = frame k+1
    (LATER), so rel_poses[k] = src->ref maps frame k's coordinates INTO
    frame k+1's. With A_k mapping frame-k coordinates to the world
    (frame-0) frame, A_{k+1} = A_k @ inv(rel_poses[k]). Returns
    (N+1, 4, 4) absolute poses with identity at the start.
    """
    traj = [np.eye(4)]
    for rel in rel_poses:
        traj.append(traj[-1] @ np.linalg.inv(np.asarray(rel)))
    return np.stack(traj)


def absolute_trajectory_error(
    traj: np.ndarray, gt_traj: np.ndarray
) -> Tuple[Dict[str, float], np.ndarray]:
    """Umeyama-align ``traj`` to ``gt_traj`` and report ATE statistics
    (reference eval_absolute_error, eval_pose_visualization_offline.py:160-215).

    Returns (errors, aligned_traj); translations in cm, rotations in degrees.
    """
    r, t, _ = umeyama_alignment(traj[:, :3, 3].T, gt_traj[:, :3, 3].T)
    align = np.eye(4)
    align[:3, :3] = r
    align[:3, 3] = t
    traj_aligned = align[None] @ traj

    delta = np.linalg.inv(gt_traj) @ traj_aligned
    trans_err = np.abs(delta[:, :3, 3])
    tr = delta[:, 0, 0] + delta[:, 1, 1] + delta[:, 2, 2]
    rot_err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))

    errors = {
        "ate_rmse_cm": float(np.sqrt(np.mean(np.sum(trans_err**2, axis=1)))) * 100,
        "ate_mean_cm": float(np.mean(trans_err)) * 100,
        "ate_std_cm": float(np.std(trans_err)) * 100,
        "rot_mean_deg": float(np.mean(rot_err)),
        "rot_std_deg": float(np.std(rot_err)),
        "rot_rmse_deg": float(np.sqrt(np.mean(rot_err**2))),
    }
    return errors, traj_aligned


def plot_trajectories(
    path: str,
    trajectories: Dict[str, np.ndarray],
    gt_traj: np.ndarray,
    title: str = "",
) -> None:
    """Bird's-eye (x, y) trajectory comparison figure (reference
    eval_traj plotting, eval_pose_visualization_offline.py:283-316)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(7, 7))
    plt.plot(gt_traj[:, 0, 3], gt_traj[:, 1, 3], "k", lw=2, label="ground truth")
    for name, traj in trajectories.items():
        plt.plot(traj[:, 0, 3], traj[:, 1, 3], lw=1.5, label=name)
    plt.xlabel("x [m]")
    plt.ylabel("y [m]")
    plt.axis("equal")
    plt.legend(loc=0)
    if title:
        plt.title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()


def recall_vs_threshold(
    rre: np.ndarray,
    rte: np.ndarray,
    rre_grid: np.ndarray,
    rte_grid: np.ndarray,
    rre_fixed: float,
    rte_fixed: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Registration recall as a function of each threshold with the other
    fixed (the recall-curve data of
    eval_visualization_for_basline_methods.py)."""
    rre = np.asarray(rre)
    rte = np.asarray(rte)
    rr_by_rre = np.array(
        [np.mean((rre < g) & (rte < rte_fixed)) for g in rre_grid]
    )
    rr_by_rte = np.array(
        [np.mean((rre < rre_fixed) & (rte < g)) for g in rte_grid]
    )
    return rr_by_rre, rr_by_rte


def plot_recall_curves(
    path: str,
    per_method: Dict[str, Tuple[np.ndarray, np.ndarray]],
    rre_fixed: float = 5.0,
    rte_fixed: float = 2.0,
    published: Dict[str, Dict[str, float]] | None = None,
) -> None:
    """Two-panel recall-vs-threshold figure. ``per_method`` maps a method
    name to its per-pair (rre_deg, rte_m) arrays; multiple methods overlay
    (this is how the reference compares against Predator/CoFiNet/GeoTr).

    ``published`` optionally overlays bundled summary results
    (utils/baselines.py): each method's published RR at the fixed
    thresholds, drawn as a level line (per-pair errors were never
    published, so full curves exist only for our own runs)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rre_grid = np.linspace(0.25, rre_fixed, 20)
    rte_grid = np.linspace(0.1, rte_fixed, 20)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    for name, (rre, rte) in per_method.items():
        rr_rre, rr_rte = recall_vs_threshold(
            rre, rte, rre_grid, rte_grid, rre_fixed, rte_fixed
        )
        ax1.plot(rre_grid, rr_rre * 100, marker=".", label=name)
        ax2.plot(rte_grid, rr_rte * 100, marker=".", label=name)
    for name, row in (published or {}).items():
        for ax in (ax1, ax2):
            ax.axhline(row["rr"], ls="--", lw=1, alpha=0.7,
                       label=f"{name} (published RR {row['rr']:.1f}%)")
    ax1.set_xlabel("RRE threshold [deg]")
    ax1.set_ylabel("registration recall [%]")
    ax1.set_title(f"RTE fixed at {rte_fixed} m")
    ax2.set_xlabel("RTE threshold [m]")
    ax2.set_title(f"RRE fixed at {rre_fixed} deg")
    ax1.legend(loc=4, fontsize=8)
    ax2.legend(loc=4, fontsize=8)
    ax1.grid(alpha=0.3)
    ax2.grid(alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_method_comparison(
    path: str,
    rows: Dict[str, Dict[str, float]],
    highlight: str | None = None,
    title: str = "",
) -> None:
    """Three-panel bar comparison (RR %, RRE deg, RTE cm) across methods —
    the summary-table counterpart of the reference's baseline-method
    comparison plots. ``rows``: method -> {rr, rre_deg, rte_cm};
    ``highlight`` draws one method (ours) in a distinct color."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(rows)
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    panels = [("rr", "RR [%]"), ("rre_deg", "RRE [deg]"), ("rte_cm", "RTE [cm]")]
    for ax, (key, label) in zip(axes, panels):
        vals = [rows[n].get(key, np.nan) for n in names]
        colors = ["tab:red" if n == highlight else "tab:blue" for n in names]
        ax.bar(range(len(names)), vals, color=colors, alpha=0.8)
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
        ax.set_ylabel(label)
        ax.grid(alpha=0.3, axis="y")
        for i, v in enumerate(vals):
            if np.isfinite(v):
                ax.text(i, v, f"{v:.2f}", ha="center", va="bottom", fontsize=7)
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def sequence_trajectory_report(
    pairs: List[dict],
    figure_dir: str,
    method: str = "lgr",
) -> Dict[str, Dict[str, float]]:
    """Per-sequence trajectory figures + ATE stats from per-pair results.

    ``pairs``: dicts with keys seq_id, src_frame, ref_frame,
    estimated_transform, gt_transform. Pairs of a sequence are chained in
    src_frame order; the chain property (each pair starts where the previous
    ended) holds for the odometry pair lists; gaps simply concatenate
    relative motions, matching the reference's npz-trajectory workflow.
    """
    out: Dict[str, Dict[str, float]] = {}
    by_seq: Dict[str, List[dict]] = {}
    for p in pairs:
        by_seq.setdefault(str(p["seq_id"]), []).append(p)
    for seq, plist in sorted(by_seq.items()):
        plist = sorted(plist, key=lambda p: (int(p["src_frame"]), int(p["ref_frame"])))
        est_traj = compose_trajectory([p["estimated_transform"] for p in plist])
        gt_traj = compose_trajectory([p["gt_transform"] for p in plist])
        errors, aligned = absolute_trajectory_error(est_traj, gt_traj)
        out[seq] = errors
        plot_trajectories(
            os.path.join(figure_dir, f"traj_seq{seq}_{method}.png"),
            {method: aligned},
            gt_traj,
            title=f"sequence {seq} ({len(plist)} pairs)",
        )
    return out
