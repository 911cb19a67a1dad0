"""Visualization exports, open3d-free (own copy of
``rdmnet_tpu/utils/visualization.py``).

The reference renders matches/votes/groupings interactively with open3d
(reference: rdmnet/utils/visualization.py:139-436, used from the model
forward when cfg.test.vis). This environment is headless and has no
open3d, so the equivalents here export standard PLY files (points with
per-vertex colors, and line sets as edge PLYs) that any viewer opens, plus
an optional matplotlib scatter for quick looks.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def write_ply_points(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud with optional (N, 3) float colors in [0, 1]."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = len(points)
    has_color = colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_color:
            rgb = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            for p, c in zip(points, rgb):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def write_ply_lines(path: str, starts: np.ndarray, ends: np.ndarray,
                    color: Tuple[float, float, float] = (0.0, 1.0, 0.0)):
    """Edge PLY connecting starts[i] -> ends[i] (correspondence lines,
    replaces the reference's o3d LineSet mesh lines)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = len(starts)
    verts = np.concatenate([starts, ends], axis=0)
    rgb = np.clip(np.asarray(color) * 255, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {2 * n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {n}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in verts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {rgb[0]} {rgb[1]} {rgb[2]}\n")
        for i in range(n):
            f.write(f"{i} {i + n}\n")


def export_correspondences(
    out_dir: str,
    ref_points: np.ndarray,
    src_points: np.ndarray,
    ref_corr: np.ndarray,
    src_corr: np.ndarray,
    corr_correct: Optional[np.ndarray] = None,
    offset: Tuple[float, float, float] = (0.0, 0.0, -30.0),
):
    """Correspondence visualization (reference visualization.py:296-436):
    the two clouds offset apart, green lines for correct matches, red for
    wrong ones."""
    offset = np.asarray(offset, np.float32)
    write_ply_points(
        os.path.join(out_dir, "ref_points.ply"), ref_points,
        np.tile([[0.1, 0.1, 0.6]], (len(ref_points), 1)),
    )
    write_ply_points(
        os.path.join(out_dir, "src_points.ply"), src_points + offset,
        np.tile([[0.1, 0.6, 0.1]], (len(src_points), 1)),
    )
    if corr_correct is None:
        write_ply_lines(
            os.path.join(out_dir, "correspondences.ply"), ref_corr, src_corr + offset
        )
    else:
        good = corr_correct.astype(bool)
        if good.any():
            write_ply_lines(
                os.path.join(out_dir, "correspondences_correct.ply"),
                ref_corr[good], src_corr[good] + offset, color=(0.0, 1.0, 0.0),
            )
        if (~good).any():
            write_ply_lines(
                os.path.join(out_dir, "correspondences_wrong.ply"),
                ref_corr[~good], src_corr[~good] + offset, color=(1.0, 0.0, 0.0),
            )


def export_votes(
    out_dir: str,
    nodes: np.ndarray,
    shifted_nodes: np.ndarray,
    keep_mask: Optional[np.ndarray] = None,
    prefix: str = "",
):
    """Vote/offset visualization (reference vis_shifte_node): lines from
    original nodes to their shifted positions; NMS survivors colored."""
    write_ply_lines(os.path.join(out_dir, f"{prefix}vote_offsets.ply"),
                    nodes, shifted_nodes, color=(1.0, 0.5, 0.0))
    colors = np.tile([[0.2, 0.2, 1.0]], (len(shifted_nodes), 1))
    if keep_mask is not None:
        colors[keep_mask.astype(bool)] = [1.0, 0.2, 0.2]
    write_ply_points(os.path.join(out_dir, f"{prefix}shifted_nodes.ply"),
                     shifted_nodes, colors)


def export_grouping(out_dir: str, points: np.ndarray, owner: np.ndarray,
                    prefix: str = ""):
    """Point-to-node grouping visualization (reference vis_node_grouping):
    each patch gets a pseudo-random color by owner id."""
    rng = np.random.RandomState(0)
    palette = rng.rand(int(owner.max()) + 1, 3) * 0.8 + 0.2
    write_ply_points(os.path.join(out_dir, f"{prefix}grouping.ply"),
                     points, palette[owner])
