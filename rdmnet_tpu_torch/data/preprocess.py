"""Offline preprocessing: voxel downsampling and registration-pair generation
(twin of ``rdmnet_tpu/data/preprocess.py``).

* ``voxel_downsample_xyzi``: voxel-centroid downsample keeping the mean
  intensity;
* ``icp_point_to_point``: point-to-point ICP whose nearest neighbour search
  runs on the device it is given: the radius-kNN CUDA kernel on the card
  (``ops.radius_search.radius_knn``, one launch per iteration over the whole
  reference cloud, its candidates re-ranked on exact distances; float64
  centroids), the native library's hash grid on the CPU (the JAX package's
  own search and arithmetic);
* ``generate_pairs_for_sequence``: pair selection (the next frame more than
  ``thres`` metres away) with the ground-truth pose from odometry and
  calibration, refined by ICP, with the corrected composition
  ``m2 = icp_tf @ m``; KITTI, KITTI-360, Apollo and MulRan layouts.
"""

from __future__ import annotations

import functools
import glob
import os
import os.path as osp
from typing import List, Optional

import numpy as np
import torch

from rdmnet_tpu_torch.data.datasets import SCHEMAS
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.graph import native
from rdmnet_tpu_torch.ops.radius_search import radius_knn
from rdmnet_tpu_torch.utils.se3_np import apply_transform


def voxel_downsample_xyzi(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """(N, 4) xyzi -> per-voxel centroid xyz + mean intensity."""
    xyz = points[:, :3]
    origin = np.floor(xyz.min(0) / voxel_size) * voxel_size
    coords = np.floor((xyz - origin) / voxel_size).astype(np.int64)
    order = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2]))
    sc = coords[order]
    sp = points[order]
    new_seg = np.concatenate([[True], np.any(sc[1:] != sc[:-1], axis=1)])
    seg_ids = np.cumsum(new_seg) - 1
    n_seg = seg_ids[-1] + 1
    sums = np.zeros((n_seg, points.shape[1]), np.float64)
    np.add.at(sums, seg_ids, sp)
    counts = np.bincount(seg_ids, minlength=n_seg)[:, None]
    return (sums / counts).astype(np.float32)


ICP_CANDIDATES = 8  # the kernel's nearest rows that ``nearest_within`` re-ranks


def candidate_radius(radius: float, extent: float) -> float:
    """``radius`` widened by the error of the kernel's float32
    ``|q|^2 - 2 q.s + |s|^2`` (a few ulps of ``|q|^2 + |s|^2``, taken as 32
    ulps of ``extent^2``), so that no point within ``radius`` falls outside."""
    return (radius * radius + 2.0 ** -19 * extent * extent) ** 0.5


def nearest_within(cur: torch.Tensor, ref: torch.Tensor, radius: float,
                   extent: float) -> torch.Tensor:
    """Index of each moved point's nearest reference point within ``radius``
    (``len(ref)`` where none) -> (N,) int64, on the card: one launch of the
    radius-kNN kernel, then an exact re-rank.

    The kernel measures ``|q|^2 - 2 q.s + |s|^2`` in float32, the graph
    build's rounding, which is off by up to a few float32 ulps of
    ``|q|^2 + |s|^2``: ~1e-3 m^2 at 80 m from the sensor, where the nearest
    point of a 0.3 m cloud lies ~1e-2 m^2 away. So the kernel returns the
    ``ICP_CANDIDATES`` nearest rows within ``candidate_radius`` (``extent``
    bounds every point's norm), and the nearest of them by the
    float64 distance of the float32 points is kept if it lies within
    ``radius``, as the native library's search decides on ``(q - s)^2``.
    ``cur`` is the float64 moved cloud, rounded to float32 for the search as
    the JAX package rounds it for the native library."""
    n_ref = ref.shape[0]
    count = torch.tensor(n_ref, dtype=torch.int32, device=ref.device)
    q = cur.to(torch.float32)
    cand = radius_knn(q, ref, count, candidate_radius(radius, extent),
                      ICP_CANDIDATES).to(torch.int64)
    d2 = ((q.double()[:, None, :] - ref.double()[cand.clamp(max=n_ref - 1)]) ** 2).sum(-1)
    d2 = torch.where(cand < n_ref, d2, torch.full_like(d2, float("inf")))
    best, pick = d2.min(dim=1)
    idx = cand.gather(1, pick[:, None])[:, 0]
    r2 = float(np.float32(radius) * np.float32(radius))  # the native library's float r * r
    return torch.where(best <= r2, idx, torch.full_like(idx, n_ref))


def _pair_stats_card(src_t, ref32, transform, radius, extent):
    """One iteration's pairing on the card: (pair count, 3x3 cross-covariance,
    source centroid, reference centroid) in float64, brought to the host in
    one copy. Unpaired rows are masked, not dropped, so nothing waits on
    the card before that copy. ``extent`` bounds the norms of the source and
    reference points (the source norm before ``transform``)."""
    tf = torch.as_tensor(transform, device=src_t.device)
    cur = src_t @ tf[:3, :3].T + tf[:3, 3]
    reach = max(extent[0] + float(np.linalg.norm(transform[:3, 3])), extent[1])
    idx = nearest_within(cur, ref32, radius, reach)
    n_ref = ref32.shape[0]
    w = (idx < n_ref).to(torch.float64)[:, None]
    n = w.sum()
    b = ref32[idx.clamp(max=n_ref - 1)].to(torch.float64)
    mu_a = (cur * w).sum(0) / n.clamp(min=1.0)
    mu_b = (b * w).sum(0) / n.clamp(min=1.0)
    h = ((cur - mu_a) * w).T @ (b - mu_b)
    stats = torch.cat([n[None], h.reshape(-1), mu_a, mu_b]).cpu().numpy()
    return int(stats[0]), stats[1:10].reshape(3, 3), stats[10:13], stats[13:16]


def _pair_stats_host(src, ref, transform, radius):
    """The same on the host with the native search, in the JAX package's
    arithmetic (its reference centroid is a float32 mean)."""
    cur = apply_transform(src, transform)
    idx = native.radius_knn_native(cur, ref, len(ref), radius, 1)[:, 0]
    valid = idx < len(ref)
    a, b = cur[valid], ref[idx[valid]]
    mu_a, mu_b = a.mean(0), b.mean(0)
    return int(valid.sum()), (a - mu_a).T @ (b - mu_b), mu_a, mu_b


def icp_point_to_point(src: np.ndarray, ref: np.ndarray, init: Optional[np.ndarray] = None,
                       max_correspondence_distance: float = 0.5, max_iterations: int = 50,
                       tolerance: float = 1e-7, device=None) -> np.ndarray:
    """Point-to-point ICP: the (4, 4) float64 transform aligning src -> ref.

    Each iteration pairs every moved source point with its nearest reference
    point within ``max_correspondence_distance``, then solves the rigid
    update by SVD Procrustes on the host; it stops when the update moves no
    entry by ``tolerance`` or fewer than 10 points pair up. On the card
    (the default) the search is the radius-kNN kernel re-ranked exactly
    (``nearest_within``) and the moved cloud, centroids and cross-covariance
    are float64 there, with one copy to the host per iteration
    (``_pair_stats_card``). With ``device="cpu"`` the
    iteration is the JAX package's: the native search and numpy
    (``_pair_stats_host``), so the result equals the JAX package's.
    """
    dev = resolve_device(device)
    transform = np.eye(4) if init is None else np.array(init, np.float64)
    ref32 = np.ascontiguousarray(ref, np.float32)
    if dev.type == "cuda":
        extent = (float(np.linalg.norm(src, axis=1).max()),
                  float(np.linalg.norm(ref32, axis=1).max()))
        pair_stats = functools.partial(_pair_stats_card, extent=extent)
        clouds = (torch.as_tensor(np.asarray(src), dtype=torch.float64, device=dev),
                  torch.as_tensor(ref32, device=dev))
    else:
        pair_stats, clouds = _pair_stats_host, (src, ref32)
    for _ in range(max_iterations):
        n, h, mu_a, mu_b = pair_stats(*clouds, transform, max_correspondence_distance)
        if n < 10:
            break
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        delta = np.eye(4)
        delta[:3, :3] = r
        delta[:3, 3] = mu_b - r @ mu_a
        transform = delta @ transform
        if np.abs(delta - np.eye(4)).max() < tolerance:
            break
    return transform


# ---------------------------------------------------------------- readers

def read_kitti_poses(path: str) -> np.ndarray:
    """Odometry poses file: one 3x4 row-major pose per line -> (N, 4, 4)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(data), 1, 1))
    out[:, :3, :] = data
    return out


def read_velo2cam(calib_path: str) -> np.ndarray:
    """'Tr:' line of a KITTI calib.txt -> (4, 4) velodyne->camera."""
    with open(calib_path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array([float(x) for x in line.split()[1:]]).reshape(3, 4)
                out = np.eye(4)
                out[:3, :] = vals
                return out
    raise ValueError(f"no Tr line in {calib_path}")


def read_cam_to_velo(path: str) -> np.ndarray:
    """KITTI-360 calibration/calib_cam_to_velo.txt: 12 floats -> (4, 4)."""
    vals = np.genfromtxt(path).reshape(3, 4)
    out = np.eye(4)
    out[:3, :] = vals
    return out


def read_kitti360_cam0_poses(path: str):
    """KITTI-360 data_poses/.../cam0_to_world.txt: 'frame p00..p33' rows ->
    (frame_ids (N,), poses (N, 4, 4))."""
    data = np.loadtxt(path)
    return data[:, 0].astype(np.int64), data[:, 1:17].reshape(-1, 4, 4)


class DatasetAdapter:
    """Scan paths and pose/calibration conventions of one dataset's raw
    layout: per-sequence poses (the sensor trajectory in a common frame), the
    velodyne<->pose-frame calibration and the scan files."""

    # lazy: the patterns format sequences of different types (MulRan's are names)
    _SCAN_GLOBS = {
        "kitti": lambda seq: f"sequences/{seq:02d}/velodyne/*.bin",
        "kitti360": lambda seq: f"data_3d_raw/2013_05_28_drive_{seq:04d}_sync/velodyne_points/data/*.bin",
        "apollo": lambda seq: f"kitti_format/MapData/ColumbiaPark/2018-09-21/{seq:02d}/velodyne/*.bin",
        "mulran": lambda seq: f"{seq}/sensor_data/Ouster/*.bin",
    }
    _SCAN_PATHS = {
        "kitti": lambda seq, frame: f"sequences/{seq:02d}/velodyne/{frame:06d}.bin",
        "kitti360": lambda seq, frame: f"data_3d_raw/2013_05_28_drive_{seq:04d}_sync/velodyne_points/data/{frame:010d}.bin",
        "apollo": lambda seq, frame: f"kitti_format/MapData/ColumbiaPark/2018-09-21/{seq:02d}/velodyne/{frame:06d}.bin",
        "mulran": lambda seq, frame: f"{seq}/sensor_data/Ouster/{frame:d}.bin",
    }

    def __init__(self, dataset: str, root: str):
        self.dataset = dataset
        self.root = root

    def scan_paths(self, seq):
        return sorted(glob.glob(osp.join(self.root, self._SCAN_GLOBS[self.dataset](seq))))

    def frame_ids(self, seq):
        return sorted(int(osp.splitext(osp.basename(f))[0]) for f in self.scan_paths(seq))

    def scan_path(self, seq, frame):
        return osp.join(self.root, self._SCAN_PATHS[self.dataset](seq, frame))

    def poses_and_calib(self, seq):
        """(frame of each pose row or None, poses (N, 4, 4), velo2cam (4, 4))."""
        if self.dataset == "kitti":
            poses = read_kitti_poses(osp.join(self.root, "poses", f"{seq:02d}.txt"))
            v2c = read_velo2cam(osp.join(self.root, "sequences", f"{seq:02d}", "calib.txt"))
            return None, poses, v2c
        if self.dataset == "kitti360":
            frames, poses = read_kitti360_cam0_poses(
                osp.join(self.root, "data_poses", f"2013_05_28_drive_{seq:04d}_sync",
                         "cam0_to_world.txt"))
            cam_to_velo = read_cam_to_velo(
                osp.join(self.root, "calibration", "calib_cam_to_velo.txt"))
            return frames, poses, np.linalg.inv(cam_to_velo)
        if self.dataset == "apollo":
            poses = read_kitti_poses(osp.join(
                self.root, "kitti_format/MapData/ColumbiaPark/2018-09-21", f"{seq:02d}",
                "poses.txt"))
            return None, poses, np.eye(4)
        if self.dataset == "mulran":
            poses = read_kitti_poses(osp.join(self.root, str(seq), "sensor_data",
                                              "poses_in_kitti_format.txt"))
            # scan names are timestamps: pose row i <-> the i-th sorted scan
            return np.asarray(self.frame_ids(seq)), poses, np.eye(4)
        raise ValueError(self.dataset)


def downsample_dataset_sequence(dataset: str, root: str, seq, voxel_size: float = 0.3,
                                out_root: Optional[str] = None,
                                keep_intensity: bool = True) -> int:
    """Downsample one sequence's raw ``.bin`` scans into the schema's
    ``.npy`` clouds (MulRan drops the intensity). Returns the scan count."""
    adapter = DatasetAdapter(dataset, root)
    out_root = out_root or root
    schema = SCHEMAS[dataset]
    n = 0
    for fname in adapter.scan_paths(seq):
        frame = int(osp.splitext(osp.basename(fname))[0])
        out_path = osp.join(out_root, schema.cloud_path.format(seq=seq, frame=frame))
        os.makedirs(osp.dirname(out_path), exist_ok=True)
        points = np.fromfile(fname, dtype=np.float32).reshape(-1, 4)
        if dataset == "mulran" or not keep_intensity:
            points = np.concatenate([points[:, :3], np.zeros((len(points), 1), np.float32)], 1)
        np.save(out_path, voxel_downsample_xyzi(points, voxel_size))
        n += 1
    return n


def _icp_cloud(path: str, voxel: float) -> np.ndarray:
    xyz = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    xyzi = np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)], 1)
    return voxel_downsample_xyzi(xyzi, voxel)[:, :3]


def generate_pairs_for_sequence(root: str, seq, thres: float = 10.0, icp_voxel: float = 0.3,
                                out_root: Optional[str] = None, dataset: str = "kitti",
                                device=None) -> List[str]:
    """Pair selection with ICP-refined ground truth for one sequence; writes
    ``<out_root>/icp<thres>/<seq>`` and returns its lines. ICP runs on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    out_root = out_root or root
    adapter = DatasetAdapter(dataset, root)
    frame_map, poses, velo2cam = adapter.poses_and_calib(seq)

    inames = adapter.frame_ids(seq)
    iname_set = set(inames)
    # pose row i belongs to frame frame_map[i] (KITTI-360, MulRan); else row == frame
    row_of_frame = None if frame_map is None else {int(f): i for i, f in enumerate(frame_map)}

    def pose_of(frame):
        return poses[frame if row_of_frame is None else row_of_frame[frame]]

    def frame_at_offset(frame, offset):
        """The frame ``offset`` pose rows after ``frame`` (None past the end)."""
        if row_of_frame is None:
            return frame + offset
        row = row_of_frame.get(frame)
        if row is None or row + offset >= len(frame_map) or row + offset < 0:
            return None
        return int(frame_map[row + offset])

    ts = poses[:, :3, 3]
    lines = []
    # sparse pose files (KITTI-360) start at the first scan that has a pose
    if row_of_frame is not None:
        posed = [f for f in inames if f in row_of_frame]
        curr = posed[0] if posed else -1
    else:
        curr = inames[0]
    while curr in iname_set:
        row = curr if row_of_frame is None else row_of_frame[curr]
        # the frame before the first one more than `thres` metres away, within 100 rows
        hits = np.where(np.linalg.norm(ts[row:row + 100] - ts[row], axis=1) > thres)[0]
        nxt = None if len(hits) == 0 else frame_at_offset(curr, int(hits[0]) - 1)
        if nxt is None or nxt not in iname_set:
            curr = frame_at_offset(curr, 1)
            if curr is None:
                break
            continue

        # maps scan curr's velodyne frame into scan nxt's: inv(V) inv(P1) P0 V
        # with the untransposed calibration V = velo2cam
        m = np.linalg.inv(velo2cam) @ np.linalg.inv(pose_of(nxt)) @ pose_of(curr) @ velo2cam
        xyz0 = _icp_cloud(adapter.scan_path(seq, curr), icp_voxel)
        xyz1 = _icp_cloud(adapter.scan_path(seq, nxt), icp_voxel)
        icp_tf = icp_point_to_point(apply_transform(xyz0, m), xyz1,
                                    max_correspondence_distance=0.5, device=dev)
        m2 = icp_tf @ m  # the corrected composition
        lines.append(f"{curr} {nxt} " + " ".join(f"{v:.6f}" for v in m2.reshape(-1)[:12]) + " ")
        curr = frame_at_offset(nxt, 1)
        if curr is None:
            break

    icp_dir = osp.join(out_root, f"icp{int(thres)}")
    os.makedirs(icp_dir, exist_ok=True)
    gt_name = SCHEMAS[dataset].gt_file.format(seq=seq).split("/")[-1]
    with open(osp.join(icp_dir, gt_name), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return lines
