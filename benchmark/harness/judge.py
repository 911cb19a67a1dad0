"""The numbers that decide ``correct``: the program's outputs against the
reference's, and each number against its limit (``benchmark/limits/``)."""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


def rotation_gap_deg(a: np.ndarray, b: np.ndarray) -> float:
    """Angle of the rotation between two 4x4 poses, in degrees."""
    r = np.asarray(a, np.float64)[:3, :3].T @ np.asarray(b, np.float64)[:3, :3]
    c = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return math.degrees(math.acos(c))


def translation_gap_m(a: np.ndarray, b: np.ndarray) -> float:
    ta, tb = np.asarray(a, np.float64)[:3, 3], np.asarray(b, np.float64)[:3, 3]
    return float(np.linalg.norm(ta - tb))


def corr_gap(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray]) -> float:
    """Share of the correspondence rows (either side's valid rows, score > 0)
    whose points or score differ between two served answers by more than
    1e-4 m or 1e-4 (the served points are input points, exact on both
    sides; the scores carry Sinkhorn's ~3e-5 kernel-to-plain gap)."""
    va, vb = a["corr_scores"] > 0, b["corr_scores"] > 0
    rows = va | vb
    if not rows.any():
        return 0.0
    close = (np.abs(a["corr_scores"] - b["corr_scores"]) <= 1e-4) \
        & (np.abs(a["ref_corr_points"] - b["ref_corr_points"]).max(-1) <= 1e-4) \
        & (np.abs(a["src_corr_points"] - b["src_corr_points"]).max(-1) <= 1e-4)
    diff = (va != vb) | ~close  # a NaN is never close
    return float((diff & rows).sum() / rows.sum())


def fit_terms(src: np.ndarray, ref: np.ndarray, weights: np.ndarray, eps: float = 1e-5):
    """The weighted fit's H[a, b] = sum_i w_i src_c[i, a] ref_c[i, b] and its
    centroids, in float64, by the reference's formula (``cross_covariance``:
    weights over their sum plus ``eps``), over the rows weighted above 0."""
    keep = weights > 0
    w = np.asarray(weights, np.float64)[keep]
    s, r = np.asarray(src, np.float64)[keep], np.asarray(ref, np.float64)[keep]
    w = w / (w.sum() + eps)
    sc, rc = (s * w[:, None]).sum(0), (r * w[:, None]).sum(0)
    return (s - sc).T @ (w[:, None] * (r - rc)), sc, rc, s, w


def horn_optimum(h: np.ndarray) -> np.ndarray:
    """The rotation maximising tr(R H), float64 (Horn's quaternion)."""
    sxx, sxy, sxz, syx, syy, syz, szx, szy, szz = h.reshape(-1)
    k = np.array([[sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
                  [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
                  [szx - sxz, sxy + syx, syy - sxx - szz, syz + szy],
                  [sxy - syx, szx + sxz, syz + szy, szz - sxx - syy]])
    w, x, y, z = np.linalg.eigh(k)[1][:, -1]
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def fit_gap(pose: np.ndarray, src: np.ndarray, ref: np.ndarray, weights: np.ndarray) -> float:
    """How far ``pose`` lies from the optimum of the weighted fit that gives
    it (Procrustes as LGR runs it), as the largest of three shares: the
    rotation's first-order residual |skew(H R)| / |H|, its shortfall
    (tr(R* H) - tr(R H)) / |H| against the float64 optimum R*, and the
    translation's distance from ref_c - R src_c over the weighted points'
    distance from the origin. Condition-aware: a rotation about an axis the
    points leave undetermined costs nothing. Rotation terms need three
    weighted rows or more."""
    pose = np.asarray(pose, np.float64)
    if not np.isfinite(pose).all():
        return float("inf")
    rot, t = pose[:3, :3], pose[:3, 3]
    h, sc, rc, s, w = fit_terms(src, ref, weights)
    scale = max(float(np.sqrt((w * (s * s).sum(1)).sum())) if len(w) else 0.0, 1.0)
    gaps = [float(np.linalg.norm(t - (rc - rot @ sc))) / scale]
    hn = float(np.linalg.norm(h))
    if len(w) >= 3 and hn > 0:
        hr = h @ rot
        gaps.append(float(np.linalg.norm(hr - hr.T)) / (2 * hn))
        gaps.append(max(float(np.trace(horn_optimum(h) @ h) - np.trace(hr)), 0.0) / hn)
    return max(gaps)


def inlier_weights(pose: np.ndarray, answer: Mapping[str, np.ndarray], radius: float):
    """The answer's scores where ``pose`` takes a row within ``radius``, else 0."""
    pose = np.asarray(pose, np.float64)
    src = np.asarray(answer["src_corr_points"], np.float64)
    res = np.linalg.norm(np.asarray(answer["ref_corr_points"], np.float64)
                         - (src @ pose[:3, :3].T + pose[:3, 3]), axis=1)
    return np.where(res < radius, answer["corr_scores"], 0).astype(np.float64)


def pose_gaps(answer: Mapping[str, np.ndarray], ref_weights: np.ndarray,
              radius: float) -> (float, float):
    """The served pose against the fit LGR makes last, by ``fit_gap``: over
    the weights of the reference's last fit on the answer's own
    correspondences, and over the inliers of the served pose itself. The
    nearer of the two is the answer's: a rounding that flips one inlier
    decision on LGR's way moves its last fit's weights, and a fit that has
    settled keeps the inliers of its own pose."""
    pose = answer["estimated_transform"]
    src, ref = answer["src_corr_points"], answer["ref_corr_points"]
    return (fit_gap(pose, src, ref, ref_weights),
            fit_gap(pose, src, ref, inlier_weights(pose, answer, radius)))


def served_checks(program: Sequence[Mapping[str, np.ndarray]],
                  reference: Sequence[Mapping[str, np.ndarray]],
                  ref_fits: Sequence[np.ndarray], radius: float) -> Dict[str, float]:
    """The served cells' numbers over the sampled requests: the largest share
    of correspondence rows that differ from the reference's answer, and the
    largest of each answer's nearer ``pose_gaps`` (LGR, Procrustes and
    ``eigh4`` on the answer's own correspondences; ``ref_fits``: the weights
    of the reference's last fit over them). The median rotation and translation gaps between the poses
    go to standard error and are not compared: with seeded weights LGR's
    last fit is often near-degenerate, so a rounding turns the pose by a
    hundredth of a degree about an axis the points leave free."""
    rot = [rotation_gap_deg(p["estimated_transform"], r["estimated_transform"])
           for p, r in zip(program, reference)]
    tra = [translation_gap_m(p["estimated_transform"], r["estimated_transform"])
           for p, r in zip(program, reference)]
    rows = [corr_gap(p, r) for p, r in zip(program, reference)]
    both = [pose_gaps(p, w, radius) for p, w in zip(program, ref_fits)]
    poses = [min(b) for b in both]
    print(f"poses against the reference: median rotation {float(np.median(rot))!r} deg, "
          f"median translation {float(np.median(tra))!r} m; rows differing {rows}; "
          f"pose gaps (over the reference's last fit, over the pose's own inliers) {both}",
          file=sys.stderr)
    return {"corr_rows_differ_max": float(max(rows)), "pose_gap_max": float(max(poses))}


def leaf_gaps(program: Mapping[str, "object"], reference: Mapping[str, "object"],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger (``keep``: the leaves counted; the median is over them)."""
    names = list(reference) if keep is None else list(keep)
    ref_norms = {k: float(reference[k].double().norm()) for k in names}
    median = float(np.median(list(ref_norms.values())))
    out = {}
    for k in names:
        p = float(program[k].double().norm())
        out[k] = abs(p - ref_norms[k]) / max(ref_norms[k], median, 1e-30) \
            if math.isfinite(p) else float("inf")
    return out


def moved_leaves(ref_grads: Mapping[str, "object"], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: a norm at
    least ``share`` of the median leaf's."""
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    median = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= share * median]


def decide(checks: Mapping[str, float], limits: Mapping[str, float]) -> (bool, Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}): every limited number within its
    limit; a number with no limit in the cell's file is printed with limit
    None and decides nothing; a limit whose number is missing fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is not None and not (value <= limit):
            ok = False
    for name, limit in limits.items():
        if name not in checks:
            out[name] = {"value": None, "limit": limit}
            ok = False
    return ok, out


def print_checks(compared: Mapping[str, dict]) -> None:
    for name, c in compared.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
