"""Offline numpy metrics for the eval CLI (own copy of
``rdmnet_tpu/utils/metrics_np.py``; reference
geotransformer/utils/registration.py:17-406): RRE/RTE with the per-axis rpy
decomposition, overlap, inlier ratio, residual, sparse correspondence
precision, over dumped .npz files.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from rdmnet_tpu_torch.utils.se3_np import apply_transform, get_rotation_translation_from_transform


def compute_relative_rotation_error(gt_rotation: np.ndarray, est_rotation: np.ndarray) -> float:
    x = 0.5 * (np.trace(np.matmul(est_rotation.T, gt_rotation)) - 1.0)
    return float(180.0 * np.arccos(np.clip(x, -1.0, 1.0)) / np.pi)


def rotation_to_euler_xyz_degrees(rotation: np.ndarray) -> np.ndarray:
    """Euler xyz (extrinsic) angles in degrees from a rotation matrix."""
    sy = np.sqrt(rotation[0, 0] ** 2 + rotation[1, 0] ** 2)
    if sy > 1e-6:
        x = np.arctan2(rotation[2, 1], rotation[2, 2])
        y = np.arctan2(-rotation[2, 0], sy)
        z = np.arctan2(rotation[1, 0], rotation[0, 0])
    else:
        x = np.arctan2(-rotation[1, 2], rotation[1, 1])
        y = np.arctan2(-rotation[2, 0], sy)
        z = 0.0
    return np.degrees(np.array([x, y, z]))


def _wrap_angle_diff_degrees(diff: np.ndarray) -> np.ndarray:
    """Shortest signed angular difference in degrees.

    Deliberate divergence from the reference (registration.py:57-72,
    111-117 take plain euler differences): a pair whose decomposed angle
    crosses the +/-180 boundary (gt yaw 179.9 vs est -179.9 = 0.2 deg
    apart) would report ~359.8 deg and explode the per-axis aggregates.
    Headline RRE/RTE/RR never touch this path."""
    return (np.asarray(diff) + 180.0) % 360.0 - 180.0


def compute_relative_rotation_error_rpy(gt_rotation, est_rotation):
    gt = rotation_to_euler_xyz_degrees(gt_rotation)
    est = rotation_to_euler_xyz_degrees(est_rotation)
    diff = np.abs(_wrap_angle_diff_degrees(gt - est))
    return float(diff[0]), float(diff[1]), float(diff[2])


def compute_registration_error(gt_transform: np.ndarray, est_transform: np.ndarray):
    """(rre, rte, rx, ry, rz) (reference registration.py:91-108)."""
    gt_r, gt_t = get_rotation_translation_from_transform(gt_transform)
    est_r, est_t = get_rotation_translation_from_transform(est_transform)
    rre = compute_relative_rotation_error(gt_r, est_r)
    rx, ry, rz = compute_relative_rotation_error_rpy(gt_r, est_r)
    rte = float(np.linalg.norm(gt_t - est_t))
    return rre, rte, rx, ry, rz


def compute_inlier_ratio(ref_corr, src_corr, transform, positive_radius=0.1) -> float:
    if len(ref_corr) == 0:
        return 0.0
    residuals = np.linalg.norm(ref_corr - apply_transform(src_corr, transform), axis=1)
    return float(np.mean(residuals < positive_radius))


def compute_overlap(ref_points, src_points, transform, positive_radius=0.1) -> float:
    """Fraction of points with a partner within radius (symmetric mean).
    Empty point sets contribute 0 (np.mean of an empty array would be NaN
    and poison the whole eval run's aggregate)."""
    if len(ref_points) == 0 or len(src_points) == 0:
        return 0.0
    src_t = apply_transform(src_points, transform)

    def one_side(a, b):
        return np.mean(_chunked_nn_dists(a, b) < positive_radius)

    return float(0.5 * (one_side(ref_points, src_t) + one_side(src_t, ref_points)))


def _chunked_nn_dists(a: np.ndarray, b: np.ndarray, step: int = 2048) -> np.ndarray:
    """Per-row nearest-neighbor euclidean distance from ``a`` to ``b``
    (host-side chunked scan; callers guard empty inputs)."""
    mins = np.empty(len(a))
    for i in range(0, len(a), step):
        d = ((a[i : i + step, None] - b[None]) ** 2).sum(-1)
        mins[i : i + step] = d.min(1)
    return np.sqrt(mins)


def compute_correspondence_residual(ref_corr, src_corr, transform) -> float:
    if len(ref_corr) == 0:
        return 0.0
    residuals = np.linalg.norm(ref_corr - apply_transform(src_corr, transform), axis=1)
    return float(np.mean(residuals))


def evaluate_correspondences(ref_corr, src_corr, transform, positive_radius=0.1) -> Dict:
    """reference registration.py:361-375."""
    return {
        "overlap": compute_overlap(ref_corr, src_corr, transform, positive_radius),
        "inlier_ratio": compute_inlier_ratio(ref_corr, src_corr, transform, positive_radius),
        "inlier_ratio_0.3": compute_inlier_ratio(ref_corr, src_corr, transform, 0.3),
        "inlier_ratio_0.1": compute_inlier_ratio(ref_corr, src_corr, transform, 0.1),
        "residual": compute_correspondence_residual(ref_corr, src_corr, transform),
        "num_corr": int(len(ref_corr)),
    }


def compute_rotation_mse_and_mae(gt_rotation, est_rotation):
    """Anisotropic rotation error over euler angles in degrees
    (reference registration.py:111-117; +-180 wraparound fixed here —
    see _wrap_angle_diff_degrees)."""
    gt = rotation_to_euler_xyz_degrees(gt_rotation)
    est = rotation_to_euler_xyz_degrees(est_rotation)
    d = _wrap_angle_diff_degrees(gt - est)
    return float(np.mean(d ** 2)), float(np.mean(np.abs(d)))


def compute_translation_mse_and_mae(gt_translation, est_translation):
    """reference registration.py:120-124."""
    return (
        float(np.mean((gt_translation - est_translation) ** 2)),
        float(np.mean(np.abs(gt_translation - est_translation))),
    )


def compute_transform_mse_and_mae(gt_transform, est_transform):
    """reference registration.py:127-131."""
    r_mse, r_mae = compute_rotation_mse_and_mae(gt_transform[:3, :3], est_transform[:3, :3])
    t_mse, t_mae = compute_translation_mse_and_mae(gt_transform[:3, 3], est_transform[:3, 3])
    return r_mse, r_mae, t_mse, t_mae


def modified_chamfer_distance(raw_points, ref_points, src_points, gt_transform, transform):
    """Modified chamfer distance (reference modules/registration/
    metrics.py:8-44): src->raw under est transform + ref->raw under
    composed est.inv(gt)."""
    if min(len(raw_points), len(ref_points), len(src_points)) == 0:
        return 0.0
    aligned_src = apply_transform(src_points, transform)

    def nn_mean(a, b):
        return float(_chunked_nn_dists(a, b).mean())

    chamfer_p_q = nn_mean(aligned_src, raw_points)
    composed = transform @ np.linalg.inv(gt_transform)
    aligned_raw = apply_transform(raw_points, composed)
    chamfer_q_p = nn_mean(ref_points, aligned_raw)
    return chamfer_p_q + chamfer_q_p


def evaluate_sparse_correspondences(
    num_ref, num_src, ref_corr_indices, src_corr_indices, gt_corr_indices
) -> Dict:
    """reference registration.py:378-406."""
    gt_mat = np.zeros((num_ref, num_src))
    if len(gt_corr_indices):
        gt_mat[gt_corr_indices[:, 0], gt_corr_indices[:, 1]] = 1.0
    pred_mat = np.zeros_like(gt_mat)
    pred_mat[ref_corr_indices, src_corr_indices] = 1.0

    pos = gt_mat * pred_mat
    precision = pos.sum() / (pred_mat.sum() + 1e-12)
    recall = pos.sum() / (gt_mat.sum() + 1e-12)
    pos_b, gt_b = pos > 0, gt_mat > 0
    ref_hit = np.any(pos_b, 1).sum() / (np.any(gt_b, 1).sum() + 1e-12)
    src_hit = np.any(pos_b, 0).sum() / (np.any(gt_b, 0).sum() + 1e-12)
    return {
        "precision": float(precision),
        "recall": float(recall),
        "hit_ratio": float(0.5 * (ref_hit + src_hit)),
    }


def compute_relative_translation_error(gt_translation, est_translation) -> float:
    """Isotropic RTE = ||t - t_est|| (reference registration.py:76-89)."""
    return float(np.linalg.norm(np.asarray(gt_translation) - np.asarray(est_translation)))


def compute_registration_rmse(src_points, gt_transform, est_transform) -> float:
    """Re-alignment error (Rotated-3DMatch-style approximated RMSE,
    reference registration.py:136-152): mean distance between src points
    under the GT vs estimated transform."""
    gt_points = apply_transform(src_points, gt_transform)
    est_points = apply_transform(src_points, est_transform)
    return float(np.linalg.norm(gt_points - est_points, axis=1).mean())


def get_correspondences(ref_points, src_points, transform=None, matching_radius=None):
    """(C, 2) GT correspondence indices: all (i, j) pairs within
    matching_radius after aligning src (reference registration.py:203-216).

    scipy-free chunked implementation of the reference's cKDTree ball query
    (this is the host/offline twin; the training path uses the on-device
    ops.correspondences.radius_correspondence_masks instead).
    """
    if matching_radius is None:
        raise ValueError("matching_radius is required")
    if transform is not None:
        src_points = apply_transform(src_points, transform)
    r2 = matching_radius * matching_radius
    out = []
    step = max(1, int(2**22 // max(len(src_points), 1)))
    for start in range(0, len(ref_points), step):
        tile = ref_points[start:start + step]
        d2 = ((tile[:, None, :] - src_points[None, :, :]) ** 2).sum(-1)
        # inclusive <=: cKDTree.query_ball_point counts points ON the radius
        ii, jj = np.nonzero(d2 <= r2)
        out.append(np.stack([ii + start, jj], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(out, axis=0).astype(np.int64)


def evaluate_overlap(
    ref_n2p_scores_c,
    src_n2p_scores_c,
    ref_points_f,
    src_points_f,
    ref_node,
    src_node,
    transform,
    n2p_overlap_thres,
) -> Dict:
    """Mean/std of predicted node-to-point overlap scores split by the GT
    label (node within n2p_overlap_thres of the other cloud's fine points) —
    reference registration.py:283-336 (its live n2p branch; the n2n branch
    there is commented out, and the dead score args are dropped here)."""
    src_node = apply_transform(src_node, transform)
    src_points_f = apply_transform(src_points_f, transform)
    ref_min = _chunked_nn_dists(ref_node, src_points_f)
    src_min = _chunked_nn_dists(src_node, ref_points_f)
    ref_mask = ref_min < n2p_overlap_thres
    src_mask = src_min < n2p_overlap_thres
    return {
        "n2p_p_mean": float((ref_n2p_scores_c[ref_mask].mean()
                             + src_n2p_scores_c[src_mask].mean()) / 2),
        "n2p_n_mean": float((ref_n2p_scores_c[~ref_mask].mean()
                             + src_n2p_scores_c[~src_mask].mean()) / 2),
        "n2p_p_std": float((ref_n2p_scores_c[ref_mask].std()
                            + src_n2p_scores_c[src_mask].std()) / 2),
        "n2p_n_std": float((ref_n2p_scores_c[~ref_mask].std()
                            + src_n2p_scores_c[~src_mask].std()) / 2),
    }


def evaluate_node_overlap(
    num_ref, num_src, ref_corr_indices, src_corr_indices, gt_corr_indices, gt_corr_overlap
):
    """Overlap statistics of predicted node correspondences vs GT overlaps
    (reference registration.py:338-359): mean GT overlap at predicted pairs,
    mean GT overlap, mean at true-positive pairs, and the mean best-per-node
    GT overlap."""
    gt_mat = np.zeros((num_ref, num_src))
    gt_mat[gt_corr_indices[:, 0], gt_corr_indices[:, 1]] = 1.0
    pred_mat = np.zeros_like(gt_mat)
    pred_mat[ref_corr_indices, src_corr_indices] = 1.0
    overlap_mat = np.zeros_like(gt_mat)
    overlap_mat[gt_corr_indices[:, 0], gt_corr_indices[:, 1]] = gt_corr_overlap
    row_best = overlap_mat.max(0)
    col_best = overlap_mat.max(1)
    gt_max_overlap = (row_best[row_best > 0].mean() + col_best[col_best > 0].mean()) / 2
    pred_overlap = overlap_mat[ref_corr_indices, src_corr_indices].mean()
    gt_overlap = gt_corr_overlap.mean()
    pred_true_overlap = overlap_mat[gt_mat * pred_mat > 0].mean()
    return (
        float(pred_overlap),
        float(gt_overlap),
        float(pred_true_overlap),
        float(gt_max_overlap),
    )
